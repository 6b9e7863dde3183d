"""Batch runtime: dynamic batching in front of the card."""

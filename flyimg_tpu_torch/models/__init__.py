"""Closed-form models: smart crop."""

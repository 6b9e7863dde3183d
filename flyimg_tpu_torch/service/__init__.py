"""HTTP service on the standard library."""

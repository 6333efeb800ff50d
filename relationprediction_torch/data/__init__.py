"""Dataset readers and synthetic generators (numpy only)."""

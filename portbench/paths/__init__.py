"""Window paths: what a cell's window drives, by traffic kind."""

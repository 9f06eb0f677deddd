"""Parameter carry-over into the port."""

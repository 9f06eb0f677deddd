"""The port's editing engine: the Editor and its builder."""

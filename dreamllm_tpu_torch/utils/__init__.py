"""Small utilities shared by the port's entry points."""

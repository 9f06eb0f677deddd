"""Per-transform alpha schedules of the port."""

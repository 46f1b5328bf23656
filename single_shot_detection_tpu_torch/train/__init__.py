"""Step functions (this slice: the predict step)."""

"""Tools run beside the benchmark: the no-drop budget finder and the
correctness readings."""

"""Scores of a run against saved float64 anchors (NumPy only)."""

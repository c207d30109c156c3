"""DeltaTree construction and DFS layout (NumPy copies)."""

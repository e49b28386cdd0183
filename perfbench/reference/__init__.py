"""Plain references the cells are held to."""

"""Command-line launchers (serving, training) and the shape cells."""

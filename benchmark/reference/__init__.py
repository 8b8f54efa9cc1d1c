"""The plain reference and the reading of the program's outputs."""

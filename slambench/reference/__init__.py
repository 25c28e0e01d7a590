"""Plain references that the program's outputs are held to. Nothing here
imports the program or JAX."""

"""The plain reference of the benchmark: numpy BFS path counting."""

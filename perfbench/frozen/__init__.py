"""Frozen copies of the program's input generators: the benchmark's inputs
stay what they are when the program's own copies change."""

"""The benchmark's harness: the command line, the drivers, the traced
readings and the counts of work; see ``main.py``."""

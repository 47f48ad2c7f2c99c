"""The plain reference the benchmark judges the program against; it
imports nothing of the program."""

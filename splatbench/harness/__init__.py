"""The harness: cells, traffic, the program under test and its trace."""

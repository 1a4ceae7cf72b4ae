"""The plain reference the served tokens are judged against. It imports
torch and ``portbench.weights`` alone: nothing of the program."""

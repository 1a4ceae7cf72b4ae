"""Entry points: the serving launcher."""

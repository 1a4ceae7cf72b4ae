"""Entry points: the serving and training launchers."""

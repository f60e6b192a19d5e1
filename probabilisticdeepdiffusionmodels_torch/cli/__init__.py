"""The command-line entry points: ``cli.train``, ``cli.sample``, ``cli.eval``."""

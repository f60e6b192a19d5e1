"""Evaluation: the variational bound in bits/dim."""

from .nll import calculate_likelihood

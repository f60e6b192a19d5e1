"""Evaluation: the variational bound in bits/dim, the exact ODE likelihood
of the continuous families, and the FID family (InceptionV3 features, FID,
KID, the Inception Score, improved precision and recall)."""

from .is_score import inception_score_from_features, inception_score_from_logits
from .kid import kernel_inception_distance, polynomial_mmd2
from .nll import calculate_likelihood
from .prd import knn_precision_recall

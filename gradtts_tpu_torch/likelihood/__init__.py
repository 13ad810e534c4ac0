"""SDE library and the probability-flow ODE log-likelihood."""

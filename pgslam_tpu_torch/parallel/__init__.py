"""The fleet: batched registration and N agents over one pose graph."""

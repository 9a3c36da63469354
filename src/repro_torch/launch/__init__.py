"""Step builders of the LM serving slice and the evaluation service."""

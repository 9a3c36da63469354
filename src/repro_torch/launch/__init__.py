"""Step builders of the LM serving slice."""

"""Graph, pruning, dataset, the two-stage GNN surrogate and its engine."""

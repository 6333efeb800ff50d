"""Ranking and the MRR scorer."""

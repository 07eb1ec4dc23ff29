"""Synthetic federated tasks and their partitions (numpy)."""

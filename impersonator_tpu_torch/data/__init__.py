"""Datasets and the batch loader of the trainer."""

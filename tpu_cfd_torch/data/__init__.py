"""Data-generation drivers."""

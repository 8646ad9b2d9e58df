"""Helpers shared by the frontend."""

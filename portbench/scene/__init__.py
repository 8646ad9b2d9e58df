"""Frames and ground truth made from the seed (``render``)."""

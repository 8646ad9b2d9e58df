"""Sequence drivers: frame-to-frame visual odometry."""

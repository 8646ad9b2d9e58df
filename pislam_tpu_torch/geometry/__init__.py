"""Geometry of the VO path: SE(3), lens distortion, epipolar solves, RANSAC."""

"""Checkpointed running of long SLAM loops (single process)."""

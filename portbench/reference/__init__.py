"""The plain references that decide ``correct``: a frozen ORB frontend and
matcher (``orb``) and trajectory comparisons against ground truth
(``trajectory``). Nothing here imports the port."""

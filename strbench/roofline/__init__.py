"""Operation and byte counts of the port's kernels, one file per kernel,
and the published peaks of the card they are held against."""

"""The plain reference the benchmark holds the program to: the stutter EM
(em.py), the alignment HMM (hmm.py) and the fused posteriors
(posteriors.py), in plain PyTorch, importing nothing of the program."""

"""Training runtime of the PyTorch port: the optimizers
(``runtime/optimizer.py``). Data, checkpoints and the elastic trainer are
not ported yet (ROADMAP A5b)."""

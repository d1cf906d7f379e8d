"""Training runtime of the PyTorch port: the optimizers
(``runtime/optimizer.py``), the deterministic data pipeline
(``runtime/data.py``, a copy of the reference's), checkpoints through the
object store (``runtime/checkpoint.py``) and the elastic trainer
(``runtime/train_loop.py``)."""

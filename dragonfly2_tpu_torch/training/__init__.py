"""Training loops: the attention ranker on one device (training/train.py)."""

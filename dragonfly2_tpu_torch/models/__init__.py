"""Models: the attention ranker (models/attention.py) and its weight
conversion from the reference's flax params (models/convert.py)."""

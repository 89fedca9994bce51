"""Multi-object solves (``batched.py``)."""

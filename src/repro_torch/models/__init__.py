"""The LM substrate's models: the dense family (``transformer.py``) on the
blocks of ``layers.py``, the family registry and the weight converter."""

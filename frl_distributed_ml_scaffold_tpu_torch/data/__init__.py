"""Input data of the port: the synthetic LM batches (``synthetic.py``)."""

"""Input data of the port: the synthetic LM and image batches
(``synthetic.py``) and the ImageNet source (``imagenet.py``)."""

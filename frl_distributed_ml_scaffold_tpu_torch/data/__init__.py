"""Input data of the port: the synthetic LM, image and video batches
(``synthetic.py``), the ImageNet source (``imagenet.py``), MNIST
(``mnist.py``), the video clips (``video.py``) and the step-indexed
pipeline the training loop reads them through (``pipeline.py``)."""

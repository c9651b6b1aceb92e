"""Input data of the port: the synthetic LM, image and video batches
(``synthetic.py``), the ImageNet source (``imagenet.py``), MNIST
(``mnist.py``) and the video clips (``video.py``)."""

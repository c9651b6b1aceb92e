"""Input data of the port: the synthetic LM, image and video batches
(``synthetic.py``), the ImageNet shards (``imagenet.py``), the video clip
shards (``video.py``) and the LM token bins (``lm.py``), each with its
synthetic fallback, over the shard machinery (``shards.py``) and the
native data core (``native.py``, the C++ of ``native/frl_data.cpp``),
MNIST (``mnist.py``), and the step-indexed pipeline the training loop
reads them through (``pipeline.py``)."""

"""The port's launcher (``launch.py``): config resolution with dotted
overrides, then training, eval or a dry run on one card.

    python -m frl_distributed_ml_scaffold_tpu_torch.launcher.launch \\
        --config=mnist_mlp [--device=cuda|cpu] [path.to.field=value ...]
"""

"""Training dropout for the port's models, drawn from explicit generators.

flax's ``nn.Dropout(rate)`` keeps each value with probability ``1 -
rate`` and divides the kept ones by it: ``where(keep, x / (1 - rate),
0)``. The port computes the same function; its masks cannot be JAX's
(another generator), so the tests hold them to their distribution.

Every site of a forward (the embedding, each block's attention and MLP
outputs, ...) draws its mask from a ``torch.Generator`` of its own, made
on the activations' device at that site and seeded from the step's seed
and the site's coordinates (``mix_seed``). Nothing reads or advances the
global generator. Making the generator inside the site is what keeps a
recompute right: ``torch.utils.checkpoint`` restores only the default
generators' state, so a mask drawn from a generator made outside a
checkpointed region would be drawn anew in the backward's recompute,
and the gradients would be silently wrong. Here the recompute builds
the same generator and draws the same mask, under ``trainer.remat`` and
``model.block_remat`` alike.

Under a mesh (``dist/mesh.py`` ``mesh_context``) a rank holds its rows
of the global batch, and of a tensor split over ``model`` its slice: a
site draws the mask of the whole tensor and keeps this rank's part, so
the masks do not depend on the mesh (the counterpart of the JAX
package's partitionable generator): rank r's rows are rows r of the
one-rank masks at the same seed. Under sequence parallelism a GPT site
(``seq_dim=1``) keeps the rank's tokens of the whole mask the same way.

``rate == 0`` and eval are the identity with no generator and no mask
op, so a model that trains without dropout launches what it did before.
"""

from __future__ import annotations

import torch

from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    batch_shard,
    model_shard,
    seq_shard,
)

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix_seed(seed: int, *key: int) -> int:
    """A 63-bit seed from ``seed`` and the integers of ``key`` (a step
    and microbatch, or a layer and site), through splitmix64."""
    x = _splitmix64(int(seed) & _MASK64)
    for k in key:
        x = _splitmix64(x ^ (int(k) & _MASK64))
    return x >> 1


def keep_mask(shape, rate: float, seed: int, *site: int, device,
              model_dim: int | None = None,
              seq_dim: int | None = None) -> torch.Tensor:
    """The boolean mask of one site: each value kept with probability
    ``1 - rate``, from a generator seeded by ``mix_seed(seed, *site)``.
    Under a mesh, ``shape`` is this rank's part (dim 0 its rows, dim
    ``model_dim`` its ``model`` slice; with ``model_dim=0`` the rows are
    split over ``model`` too, inside the batch shard; dim ``seq_dim`` its
    tokens over ``seq``): the whole tensor's mask is drawn and this part
    kept."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(seed, *site))
    full, index = list(shape), [slice(None)] * len(shape)
    cuts = [(0, *batch_shard())]
    if model_dim == 0:
        # Rows split over the batch axes and then over ``model`` (the
        # ViT's stream between the collective-matmul rings).
        (bi, bn), (mi, mn) = batch_shard(), model_shard()
        cuts = [(0, bi * mn + mi, bn * mn)]
    elif model_dim is not None:
        cuts.append((model_dim, *model_shard()))
    if seq_dim is not None:
        cuts.append((seq_dim, *seq_shard()))
    for dim, i, n in cuts:
        full[dim] = shape[dim] * n
        index[dim] = slice(i * shape[dim], (i + 1) * shape[dim])
    keep = torch.rand(full, generator=gen, device=device) < 1.0 - rate
    return keep[tuple(index)]


def dropout(x: torch.Tensor, rate: float, seed: int | None,
            *site: int, model_dim: int | None = None,
            seq_dim: int | None = None) -> torch.Tensor:
    """flax's ``Dropout(rate)`` in training at one site; ``seed`` None
    (eval) or ``rate`` 0 returns ``x`` itself. ``model_dim`` / ``seq_dim``:
    the dims of ``x`` split over ``model`` / ``seq`` (``keep_mask``)."""
    if seed is None or rate <= 0.0:
        return x
    split = model_dim is not None and model_shard()[1] > 1
    seq = seq_dim is not None and seq_shard()[1] > 1
    keep = keep_mask(x.shape, rate, seed, *site, device=x.device,
                     **({"model_dim": model_dim} if split else {}),
                     **({"seq_dim": seq_dim} if seq else {}))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def check_seed(rate: float, train: bool, seed: int | None) -> int | None:
    """The seed a training forward's dropout sites use: None when dropout
    is off (eval, or ``rate`` 0); a missing seed where dropout is on
    raises, as flax asks for a ``dropout`` rng."""
    if not train or rate <= 0.0:
        return None
    if seed is None:
        raise ValueError(
            f"dropout={rate} in training needs a seed (rng=...): the train "
            "step derives one per step and microbatch from trainer.seed")
    return int(seed)

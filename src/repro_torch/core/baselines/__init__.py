"""Competitor sketching algorithms from the paper's §IV (Table I), in PyTorch.

The counterparts of ``repro.core.baselines``: the same sketches and
estimators, bit for bit on the same parameters. Each module's ``make_*``
draws its parameters from a seeded CPU ``torch.Generator`` and moves them to
``device`` (default ``"cuda"``, which raises without a card); it does not
reproduce ``jax.random``, so a comparison with the reference passes the
reference's draws in as tensors. Sketches run on the parameters' device, in
plain PyTorch: none of these has a kernel of its own.

| module      | paper ref | measures                   |
|-------------|-----------|----------------------------|
| bcs         | [22,23]   | IP / Ham / JS / Cos        |
| minhash     | [5]       | JS (Cos, IP via [25],[26]) |
| doph        | [24]      | JS (densified one-permutation) |
| oddsketch   | [21]      | JS (high-similarity regime) |
| simhash     | [10]      | Cos                        |
| cbe         | [27]      | Cos (circulant, FFT)       |

Hash values are int64 tensors holding the reference's uint32 values (in
``[0, 2^32)``, so ordering and equality are the unsigned ones); packed
sketches are int32 words holding its uint32 bits, as in
:mod:`repro_torch.core.packed`.
"""

from . import bcs, cbe, doph, minhash, oddsketch, simhash  # noqa: F401

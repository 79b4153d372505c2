"""repro_torch.hopper — the Hopper (sm_90a) kernels of the port, in CUDA C++.

The counterpart of the JAX package's ``kernels/``: each of its seven Pallas
kernels has a CUDA source in ``csrc/``, a launch module, and a plain PyTorch
version in :mod:`.ref`. Callers go through :mod:`.ops`. Nothing is
compiled at import; :mod:`.build` runs ``nvcc`` at first use.

| kernel | source | replaces |
|---|---|---|
| sketch build | csrc/sketch_build.cu (+ bitmap_build.cuh) | kernels/sketch_build.py::build_sketch_kernel |
| popcount score | csrc/popcount_sim.cu | kernels/popcount_sim.py::sketch_score_kernel |
| streaming top-k | csrc/topk_stream.cu | kernels/topk_stream.py::sketch_topk_kernel |
| occupancy count | csrc/count_bins.cu | kernels/count_update.py::count_bins_kernel |
| width fold | csrc/rebucket.cu | kernels/rebucket.py::rebucket_kernel |
| band keys | csrc/band_hash.cu | kernels/band_hash.py::band_hash_kernel |
| hash-mode build | csrc/hash_build.cu (+ bitmap_build.cuh) | kernels/hash_build.py::hash_build_kernel |
"""

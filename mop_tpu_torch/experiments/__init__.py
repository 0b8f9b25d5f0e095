"""The CIFAR experiment harness of the port: the counterparts of the JAX
package's ``experiments/`` scripts, run as ``python -m
mop_tpu_torch.experiments.<name>`` (``--device cpu`` for the CPU):

- ``cifar100_ab5_param_budgets``: A/B/C/D/E at matched parameter budgets,
  trained in lockstep on the same batches;
- ``cifar{10,100}_{crossview_mixer,edgewise_gates,multihop_gates,twohop_gates}``:
  one model per seed.

``common`` holds the shared machinery (loaders, parameter matching, the
lockstep loop, statistics, output files).
"""

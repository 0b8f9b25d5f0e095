"""The CIFAR experiment harness of the port: the counterparts of the JAX
package's ``experiments/`` scripts, run as ``python -m
mop_tpu_torch.experiments.<name>`` (``--device cpu`` for the CPU):

- ``cifar100_ab5_param_budgets``: A/B/C/D/E at matched parameter budgets,
  trained in lockstep on the same batches, and ``ab5_tournament`` (its 5
  seeds at the 5M target, ``--plan_only`` for 1B budgets);
- ``cifar10_ab_param_budgets`` (A/B), ``cifar{10,100}_ab3_param_budgets``
  (A/B/C) and ``cifar100_ab4_param_budgets`` (A/B/C/D), over
  ``_param_budgets``;
- ``cifar{10,100}_twohop_param_budgets``: ``ViTGated`` matched to each budget;
- ``cifar{10,100}_multi_seed``: A against B at a fixed width, with McNemar's
  test; ``cifar10_mop_sweep``: B over views x kernels;
- ``cifar{10,100}_{crossview_mixer,edgewise_gates,multihop_gates,twohop_gates}``:
  one model per seed;
- ``ab5_paper_benchmark``: the Markdown / LaTeX tables of the A-E CSVs.

``common`` holds the shared machinery (loaders, parameter matching, the
lockstep loop, statistics, output files).
"""

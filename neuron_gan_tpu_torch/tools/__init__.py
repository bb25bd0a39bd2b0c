"""Command-line tools of the port (counterpart of the JAX package's
``tools/``), each run as ``python -m neuron_gan_tpu_torch.tools.<name>``:
the quality A/B harness (``precision_ab`` and its arm tools,
``ab_aggregate``, ``run_multiseed_ab``), the step profilers (``step_profile``,
``op_trace``), the checkpoint converter (``convert_checkpoint``) and the
1024^2 EMA run (``stretch_1024``).  Each runs on the GPU unless given
``--device cpu``."""

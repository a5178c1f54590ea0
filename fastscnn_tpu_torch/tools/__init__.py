"""The port's counterparts of ``fastscnn_tpu/tools/``: the synthetic
Cityscapes generator (``system_check``) and the studies and parity gate
run on trained weights (``argmax_first_study``, ``quant_study``,
``compare_backends``)."""

"""The port's counterparts of ``fastscnn_tpu/tools/``: the end-to-end
system check and its synthetic Cityscapes generator (``system_check``),
the studies and parity gate run on trained weights
(``argmax_first_study``, ``quant_study``, ``compare_backends``), the int8
A/B bench (``ab_int8_e2e``), manual car control (``manual_control``) and
the log, latency and FPS analyzers (``analyzers``)."""

"""The port's counterparts of ``fastscnn_tpu/tools/``: the end-to-end
system check and its synthetic Cityscapes generator (``system_check``),
the studies and parity gate run on trained weights
(``argmax_first_study``, ``quant_study``, ``compare_backends``), the int8
A/B bench (``ab_int8_e2e``), manual car control (``manual_control``), the
log, latency and FPS analyzers (``analyzers``), the dataset and annotation
tools (``dataset_tools``, ``dataset_check``, ``mask_editor``,
``annotation_server``, ``calibration_tools``), the GT-vs-prediction report
(``validate_predictions``) and the device trace's kernel table
(``xplane``)."""

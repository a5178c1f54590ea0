"""Realtime control dashboard CLI.

The port of ``fastscnn_tpu/control_dashboard.py``, with the same flags:
the port's inference engine (``--cpu`` runs it on the CPU, else on the
CUDA card), a synthetic camera, the bird's-eye view and path planning,
the visual lateral-error controller, optional serial actuation through
the native bridge (``--enable-serial``), and the web dashboard; or a
single-image run via ``--input`` (PNG, JPEG, BMP, GIF, TIFF or WebP, read
without PIL).
``--export-path`` runs an exported artifact (a ``.pt2`` of the port's
``export_model``, or an ``.onnx``) instead of the engine, through
``pipeline.build_session``. The OpenCV cameras (``--camera``,
``--video``) are not ported yet and raise.

Usage::

    # realtime with web dashboard and synthetic camera
    python -m fastscnn_tpu_torch.control_dashboard --realtime --web \
        --synthetic-camera --weights weights/fast_scnn_custom.pth

    # single image, on the CPU
    python -m fastscnn_tpu_torch.control_dashboard --cpu --input frame.jpg
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="fastscnn-tpu-torch control dashboard")
    # model
    parser.add_argument("--dataset", type=str, default="custom")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--export-path", type=str, default=None,
                        help="an exported artifact (.pt2 of export_model, or .onnx) to run "
                             "instead of the engine")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--internal-size", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    # mode
    parser.add_argument("--realtime", action="store_true", default=False)
    parser.add_argument("--input", type=str, default=None,
                        help="single-image mode (PNG, JPEG, BMP, GIF, TIFF or WebP)")
    parser.add_argument("--max-frames", type=int, default=None)
    # camera
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--synthetic-camera", action="store_true", default=False)
    parser.add_argument("--video", type=str, default=None,
                        help="replay a recorded video file (needs cv2: not ported yet)")
    parser.add_argument("--loop-video", action="store_true", default=False)
    parser.add_argument("--camera-width", type=int, default=640)
    parser.add_argument("--camera-height", type=int, default=360)
    # BEV / path
    parser.add_argument("--pixels-per-unit", type=int, default=20)
    parser.add_argument("--edge-computing", action="store_true", default=True,
                        help="fast-mode path planning (row skipping), the "
                             "realtime default; --no-edge-computing for full")
    parser.add_argument("--no-edge-computing", dest="edge_computing",
                        action="store_false")
    # control gains
    parser.add_argument("--steering-gain", type=float, default=50.0)
    parser.add_argument("--base-pwm", type=float, default=300)
    parser.add_argument("--curvature-damping", type=float, default=0.1)
    parser.add_argument("--preview-distance", type=float, default=30.0)
    parser.add_argument("--max-pwm", type=float, default=1000)
    parser.add_argument("--min-pwm", type=float, default=100)
    parser.add_argument("--ema-alpha", type=float, default=0.5)
    parser.add_argument("--disable-smoothing", action="store_true", default=False)
    # web
    parser.add_argument("--web", action="store_true", default=False)
    parser.add_argument("--web-host", type=str, default="0.0.0.0")
    parser.add_argument("--web-port", type=int, default=5000)
    # serial
    parser.add_argument("--enable-serial", action="store_true", default=False)
    parser.add_argument("--serial-port", type=str, default="/dev/ttyAMA0")
    parser.add_argument("--serial-baudrate", type=int, default=115200)
    parser.add_argument("--auto-start-driving", action="store_true", default=False)
    parser.add_argument("--output-dir", type=str, default="./output")
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU (default: the CUDA card, which raises without one)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.device = "cpu" if args.cpu else None
    from fastscnn_tpu_torch.control import VisualLateralErrorController
    from fastscnn_tpu_torch.pipeline import build_session

    session = build_session(args)
    controller = VisualLateralErrorController(
        steering_gain=args.steering_gain,
        base_pwm=args.base_pwm,
        curvature_damping=args.curvature_damping,
        preview_distance=args.preview_distance,
        max_pwm=args.max_pwm,
        min_pwm=args.min_pwm,
        ema_alpha=args.ema_alpha,
        enable_smoothing=not args.disable_smoothing,
    )

    if args.input:
        import os

        import numpy as np

        from fastscnn_tpu_torch.pipeline import inference_single_image, read_image_rgb

        img = np.ascontiguousarray(read_image_rgb(args.input)[:, :, ::-1])
        basename = os.path.splitext(os.path.basename(args.input))[0]
        result = inference_single_image(
            img,
            session,
            controller=controller,
            pixels_per_unit=args.pixels_per_unit,
            edge_computing=args.edge_computing,
            output_dir=args.output_dir,
            basename=basename,
        )
        result["perf"].print_performance_analysis("single-image control pipeline")
        return result

    if not args.realtime:
        raise SystemExit("pass --realtime or --input <image>")

    from fastscnn_tpu_torch.interfaces import DashboardServer, RealtimePipeline, SyntheticCamera

    if args.video:
        from fastscnn_tpu_torch.interfaces.realtime import VideoFileCamera

        camera = VideoFileCamera(args.video, loop=args.loop_video)
    elif args.synthetic_camera:
        camera = SyntheticCamera(args.camera_width, args.camera_height)
    else:
        from fastscnn_tpu_torch.interfaces.realtime import OpenCVCamera

        camera = OpenCVCamera(args.camera, args.camera_width, args.camera_height)

    car = None
    if args.enable_serial:
        from fastscnn_tpu_torch.serialbridge import SimpleCarController

        car = SimpleCarController(port=args.serial_port, baudrate=args.serial_baudrate)
        if not car.connect():
            print(f"warning: cannot open serial port {args.serial_port}; driving disabled")
            car = None

    pipeline = RealtimePipeline(
        session,
        camera,
        controller=controller,
        car=car,
        edge_computing=args.edge_computing,
        pixels_per_unit=args.pixels_per_unit,
    )
    pipeline.warm()  # on the card: the CUDA graph, captured before the dashboard's thread runs
    server = None
    if args.web:
        server = DashboardServer(pipeline, host=args.web_host, port=args.web_port)
        port = server.start()
        print(f"dashboard at http://{args.web_host}:{port}/")
    if args.auto_start_driving:
        pipeline.start_driving()
    try:
        pipeline.run(max_frames=args.max_frames)
    except KeyboardInterrupt:
        pass
    finally:
        pipeline.emergency_stop()
        if server is not None:
            server.stop()
    return pipeline


if __name__ == "__main__":
    main()

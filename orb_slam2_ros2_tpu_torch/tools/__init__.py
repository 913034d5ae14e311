"""Measurement tools: one module for each of the repository's JAX
measurement scripts, with the same base name (``profile_frame.py`` ↔
``tools/profile_frame.py``), run as ``python3 -m
orb_slam2_ros2_tpu_torch.tools.<name>``.

Each has ``main(argv=None) -> dict``, takes ``--device`` (default ``cuda``;
without a card it raises unless given ``--device cpu``) and prints its
result, with the card's name and power limit, as one JSON line, last.
Where the JAX script times a jitted program, the tool times the same
program as a captured CUDA graph (``frame_graph.StepGraph``) and, where the
production path replays it, the eager program beside it (``_timing``).
The kernels K1, K2 and K3 are reached only through their production wrappers,
which build from ``csrc/`` at first use.

Counterparts: ``profile_scan``, ``profile_extract``, ``profile_trace``,
``bench_micro``, ``profile_frame``, ``profile_full``, ``profile_loop``,
``profile_kf``, ``profile_ba``, ``bench_posegraph``, ``bench_io``,
``profile_orbvoc``, and the benches ``bench`` (the production frame graph
replayed over the return pass with its state carried from frame to frame),
``bench_full`` (full SLAM with the ATE gate), ``bench_loop`` (the closure's
frame-time spike) and ``bench_scaling`` (the sharded global BA over mesh
slots); ``bench_scale_run.py`` is ``orb_slam2_ros2_tpu_torch.scale_run``.
A bench whose gate fails raises ``_timing.Failed`` (exit code 1) after its
lines.  ``bench_reference_cpu.py`` times OpenCV's ORB, not this system,
and has no counterpart.
"""

TOOLS = ("profile_scan", "profile_extract", "profile_trace", "bench_micro", "profile_frame",
         "profile_full", "profile_loop", "profile_kf", "profile_ba", "bench_posegraph", "bench_io",
         "profile_orbvoc", "bench", "bench_full", "bench_loop", "bench_scaling")

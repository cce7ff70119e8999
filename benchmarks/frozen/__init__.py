"""Frozen copies that the benchmark measures with: the traffic generator
(:mod:`.traffic`, from ``eventad_tpu_torch/data/fixtures.make_sequence``)
and the counts (:mod:`.counts`: the scoring forward's roofline, the
streaming step's FLOPs, the head-training FLOPs and the per-kernel bound
rule of ``chip_smoke.py``).  They import nothing of the program, so a
change to the program cannot move the yardstick; ``benchmarks/tests``
holds each against the program's function as it stood when it was
copied."""

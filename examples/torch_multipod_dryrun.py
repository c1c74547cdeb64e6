"""Example: one multi-pod dry-run cell through the PyTorch port.

Counts rank 0's own step of qwen3-32b train_4k on the 2x16x16
(512-device) production mesh, on ``meta`` tensors in a counting world
(no card, no storage), then prints its operations, the bytes its
collectives send by mesh axes, its peak and argument bytes, and the
roofline terms against the H100 figures of ``launch.mesh.HW``.

The counterpart of ``examples/multipod_dryrun.py`` through
``repro_torch``; ``launch.dryrun``'s module doc says what XLA's
analyses report there that has no counterpart here.

Run:  PYTHONPATH=src python examples/torch_multipod_dryrun.py \\
          [--arch qwen3-32b] [--shape train_4k]
"""
import argparse

from repro_torch.launch.dryrun import analyze_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)

    result = analyze_cell(args.arch, args.shape, mca=False, multi_pod=True)
    print(f"cell              : {args.arch} {args.shape} on "
          f"{result['devices']} devices")
    print(f"count time        : {result['count_s']:.1f}s")
    print(f"flops (global)    : {result['flops_global']:.3e}")
    print(f"flops (rank 0)    : {result['flops']:.3e}")
    print(f"useful fraction   : {result['useful_fraction']:.3f}")
    print("collective bytes (rank 0) by mesh axes:")
    for axes, row in result["collectives"]["by_axes"].items():
        print(f"  {axes:16s} {row['total_bytes'] / 1e9:.3f} GB")
    print(f"peak beyond args  : {result['temp_size_in_bytes'] / 1e9:.3f} GB")
    print("argument bytes / device:")
    for name, n in result["argument_bytes"].items():
        print(f"  {name:16s} {n / 1e9:.3f} GB")
    print(f"roofline terms    : {result['roofline']}")


if __name__ == "__main__":
    main()

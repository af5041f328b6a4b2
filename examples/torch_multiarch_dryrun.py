"""Walkthrough on the port: partition one cell of each architecture family
on the production mesh and print its roofline terms (the dry run in
example form).

    PYTHONPATH=src python examples/torch_multiarch_dryrun.py [--cell gat-cora::full_graph_sm]

Each cell's step runs once on meta tensors, partitioned on the (16, 16)
mesh over torch's fake process group (``repro_torch.launch.dryrun``), and
is counted per device: no card and no kernel build, so it runs on the CPU
and takes no ``--device``.  ``--cell`` (repeatable) picks the cells; the
default is one a family, as in the reference's example.  No record is
written.
"""
import argparse

from repro_torch.launch import dryrun

CELLS = [
    "dpmf::train_1m",            # the paper's model
    "gemma-7b::decode_32k",      # dense LM serving
    "gat-cora::full_graph_sm",   # GNN
    "fm::retrieval_cand",        # recsys retrieval
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cell", action="append", default=None, metavar="ARCH::SHAPE")
    args = parser.parse_args(argv)

    out = {}
    for cell in args.cell or CELLS:
        arch, shape = cell.split("::")
        print(f"=== {arch} :: {shape} (16x16 production mesh) ===")
        record = dryrun.run_cell(arch, shape, multi_pod=False)
        cost, roof, mem = record["cost"], record["roofline"], record["memory"]
        print(f"[ok]       {arch}::{shape} {record['partition']} count={record['count_s']:.2f}s "
              f"flops={cost['flops']:.3e} least_bytes={cost['least_bytes']:.3e} "
              f"collective_bytes={record['collectives']['total_bytes']:.3e} "
              f"args={mem['argument_size_bytes']:.3e} temp={mem['temp_size_bytes']:.3e} "
              f"{roof['dominant']} {roof['bound_s'] * 1e3:.3f} ms")
        out[cell] = record
    print("all example cells partitioned + counted OK")
    return out


if __name__ == "__main__":
    main()

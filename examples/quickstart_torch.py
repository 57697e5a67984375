"""Quickstart: every partitioner through the one front door, `repro_torch.api`
(the port of `examples/quickstart.py`).

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host

One source spec + one ordering flag replaces the old generate / permute /
configure dance: the mesh is built from ``gen:grid:side=64`` and streamed
in random order (the adversarial setting the paper targets), and each
method is selected by registry name.  The V-cycles run on the card unless
``--device cpu`` is given; with no card the first run raises.
"""
import argparse

from repro_torch.api import partition

SOURCE = "gen:grid:side=64"                     # 4096 nodes, mesh family
OPTS = dict(k=16,
            buffer_size=512,                    # Q_max — the central memory/quality knob
            batch_size=128,                     # delta — multilevel batch size
            d_max=256,                          # hub threshold (immediate Fennel)
            ordering="random", order_seed=42,   # destroy stream locality
            collect_stats=True)


def main(device: str = "cuda") -> dict:
    """Run the five partitions on `device`, print one quality line each,
    check BuffCut beats Fennel, and return the `PartitionResult`s by name."""
    results = {name: partition(SOURCE, driver=name, device=device, **OPTS)
               for name in ("buffcut", "heistream", "fennel")}
    results["buffcut+restream"] = partition(SOURCE, driver="buffcut", device=device,
                                            restream_passes=1, **OPTS)
    results["…priority"] = partition(SOURCE, driver="buffcut", device=device,
                                     restream_passes=1, restream_order="priority",
                                     **OPTS)

    for name, res in results.items():
        print(f"{name:16s} cut={100 * res.cut_ratio:5.2f}%  "
              f"balance={res.balance:.3f}  ier={res.ier:.3f}")

    ran_on = sorted({res.provenance["device"] for res in results.values()})
    if ran_on != [device]:
        raise RuntimeError(f"asked for device {device!r}, the runs report {ran_on}")
    print(f"device={device} ({len(results)} runs)")
    if not results["buffcut"].cut_ratio < results["fennel"].cut_ratio:
        raise RuntimeError("BuffCut should beat Fennel")
    print("OK")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(device=ap.parse_args().device)

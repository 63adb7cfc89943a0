"""End-to-end GraSS data attribution with FlashSketch on the card (paper
§7.4, Fig. 4; the PyTorch twin of ``examples/grass_attribution.py``): train
an MLP, build a sketched gradient feature cache, compute attributions, and
evaluate with the linear datamodeling score (LDS).

    PYTHONPATH=src python examples/torch_grass_attribution.py
    PYTHONPATH=src python examples/torch_grass_attribution.py --full
    PYTHONPATH=src python examples/torch_grass_attribution.py --device cpu

``featurize`` is the card's own time per training example of the cache
build (the plain versions' with ``--device cpu``).  ``main`` returns each
family's ``run_grass_lds`` result, by family.  Without a CUDA device
the default ``--device cuda`` raises.
"""
import argparse

from repro_torch.attribution.grass import GrassPipelineConfig, run_grass_lds
from repro_torch.attribution.mlp import MLPConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale MLP (109k params) + m=50 subsets")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    if args.full:
        mcfg = MLPConfig(d_in=784, hidden=(256, 256), steps=120)
        n_train, n_test, m, sparse = 1024, 32, 50, 4096
        k = args.k or 1024
    else:
        mcfg = MLPConfig(d_in=128, hidden=(32, 32), steps=80)
        n_train, n_test, m, sparse = 256, 24, 24, 1024
        k = args.k or 256

    print(f"[grass] MLP{mcfg.hidden} n_train={n_train} m={m} k={k}")
    results = {}
    for fam in ("blockperm", "dense_gaussian", "sjlt", "blockrow"):
        res = results[fam] = run_grass_lds(
            GrassPipelineConfig(sparse_dim=sparse, sketch_dim=k,
                                sketch_family=fam),
            mcfg, n_train=n_train, n_test=n_test, m_subsets=m,
            device=args.device)
        print(f"[grass] {fam:16s} LDS={res['lds']:+.3f} "
              f"featurize={res['per_sample_us']:.0f}us/sample")
    return results


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Convert a Keras ``.h5`` of backbone weights into the file the PyTorch port
loads.

Opens the ``.h5`` (its ``model_weights`` group if it has one, as the JAX
package's ``load_keras_h5`` does), reads every layer group that has a
``weight_names`` attribute, its arrays in that order, and writes them with
``radnet_torch.models.weights.save_keras_layers``: nothing is mapped or
dropped here; ``load_keras_layers`` maps the layers when the port loads the
file.  Needs h5py, which the port itself never imports.

Usage:
  python scripts/h5_to_torch.py resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5 resnet50.pt
  python -m radnet_torch.cli.train --weights resnet50.pt ...
"""

from __future__ import annotations

import argparse
import os
import sys

import h5py
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_h5_layers(path: str) -> dict:
    """``{layer name: [(weight name, array), ...]}`` of every layer group."""
    layers = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name, g in root.items():
            if not isinstance(g, h5py.Group) or "weight_names" not in g.attrs:
                continue
            names = [n.decode() if isinstance(n, bytes) else str(n) for n in g.attrs["weight_names"]]
            layers[name] = [(n, np.asarray(g[n])) for n in names]
    return layers


def main(argv=None) -> int:
    from radnet_torch.models.weights import save_keras_layers

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("h5", help="the Keras weight file")
    p.add_argument("out", help="the converted file to write")
    args = p.parse_args(argv)
    layers = read_h5_layers(args.h5)
    save_keras_layers(args.out, layers)
    print(f"{args.out}: {len(layers)} layers, "
          f"{sum(a.size for ws in layers.values() for _, a in ws)} values")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Convert the reference's released PyTorch checkpoints into the JAX
package's msgpack files without flax (the port's counterpart of
``tools/convert_weights.py``, byte for byte its output):

    python -m impersonator_tpu_torch.tools.convert_weights KIND in.pth out.msgpack

KIND is one of hmr, gen, bgnet, vgg19, sphere, senet50, osnet, pcb,
inception, facenet_ir, alexnet, vgg16_features, squeeze_features, lpips
(``--src2`` the torchvision backbone, ``--net`` alex / vgg / squeeze) and
mtcnn (``in.pth`` a directory of pnet.pt / rnet.pt / onet.pt). Each file
is read with ``weights_only=True`` (SENet50's ``.pkl`` as the JAX tool
reads it), checked to load strictly into the port's module
(``utils.convert.reference_module``, directly or through its
``*_from_reference`` loader), mapped by ``utils.convert.TO_JAX`` and
written by ``utils.checkpoint.write_flax_msgpack``. It runs on the CPU
and needs no card.
"""

from __future__ import annotations

import argparse
import os

from impersonator_tpu_torch.tools import load_reference
from impersonator_tpu_torch.utils import convert
from impersonator_tpu_torch.utils.checkpoint import write_flax_msgpack


def check_loads(kind: str, sd, backbone=None, net: str = "alex") -> None:
    """Load the file strictly into the port's module(s); raises if the
    key layout or a shape does not fit."""
    if kind == "lpips":
        from impersonator_tpu_torch.metrics.zoo import LPIPS
        model = LPIPS(net)
        port = convert.lpips_from_reference(sd, backbone, net)
        if backbone is None:
            want = sorted(k for k in model.state_dict()
                          if k.startswith("lin"))
            if sorted(port) != want:
                raise ValueError(f"lin heads {sorted(port)}, LPIPS({net}) "
                                 f"holds {want}")
            return
        model.load_state_dict(port, strict=True)
        return
    port = convert.reference_state_dict(kind, sd)
    module = convert.reference_module(kind, sd)
    if kind == "mtcnn":
        for name, m in module.items():
            m.load_state_dict(port[name], strict=True)
    else:
        module.load_state_dict(port, strict=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=sorted(convert.TO_JAX))
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--src2", default=None,
                    help="lpips only: torchvision backbone .pth to embed "
                         "(alexnet / vgg16 / squeezenet1_1 per --net)")
    ap.add_argument("--net", default="alex",
                    choices=("alex", "vgg", "squeeze"),
                    help="lpips only: which backbone the lin heads "
                         "belong to")
    args = ap.parse_args(argv)

    if args.kind == "mtcnn":
        sd = {n: load_reference(os.path.join(args.src, f"{n}.pt"))
              for n in ("pnet", "rnet", "onet")}
        check_loads("mtcnn", sd)
        tree = convert.mtcnn_to_jax(sd)
    elif args.kind == "lpips":
        sd = load_reference(args.src)
        backbone = load_reference(args.src2) if args.src2 else None
        check_loads("lpips", sd, backbone, args.net)
        tree = convert.lpips_to_jax(sd, backbone, net=args.net)
    else:
        sd = load_reference(args.src)
        check_loads(args.kind, sd)
        tree = convert.TO_JAX[args.kind](sd)
    write_flax_msgpack(tree, args.dst)
    print(f"converted {args.kind}: {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()

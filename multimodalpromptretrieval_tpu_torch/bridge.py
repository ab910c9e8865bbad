"""The JAX package's params / AdamW pytrees <-> the port's modules.

The one place where layouts change, in both directions:

  * JAX dense kernels are (in, out); the port's weights are (out, in);
  * JAX stacks each tower's layers on axis 0; the port has one module per
    layer;
  * CLIP's q/k/v are already one packed ``wqkv``; T5's separate q, k, v
    kernels are the row blocks of one (3 * inner, d_model) ``qkv`` weight;
  * the BAN fusion's layers and the ResNet's blocks are lists in the JAX
    tree (``ban.res.b_net[g].v_net[i]``, ``clip_rn.layer1[b]``), numbered
    submodules in the port; a path part that is an int indexes a list (or,
    in a tree read back from an npz, the key ``str(i)``);
  * the ResNet's convolution kernels and its attention pool's q / k / v
    already have torch's layout in the JAX tree (only the pool's output
    projection is (in, out)).

:func:`name_map` lists, once, which slice of which JAX leaf each parameter of
the port is; ``params_from_jax`` / ``params_to_jax`` and the AdamW-state
pair read it in either direction (the moments share the params' layout).
``train/checkpoint.py`` writes and reads the JAX package's npz format on
top of it.

Leaves coming in may be numpy arrays (including ``ml_dtypes`` bfloat16),
anything ``numpy.asarray`` accepts, or torch tensors. Trees going out hold
CPU torch tensors; :func:`tree_numpy` turns them into numpy for the JAX
side. The result of ``params_from_jax`` is loaded with
``load_state_dict(strict=True)``, so a missing or misshapen leaf raises.
"""

from __future__ import annotations

from typing import (
    Any,
    Dict,
    Iterable,
    Iterator,
    NamedTuple,
    Optional,
    Tuple,
)

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    Mapping,
    MPRGen,
    MPRGenConfig,
)
from multimodalpromptretrieval_tpu_torch.models.resnet import (
    ResNetConfig,
    blocks,
    has_downsample,
)


class Leaf(NamedTuple):
    """Parameter ``name`` of the port is ``tree[path]`` (row ``layer`` of
    it when the JAX leaf stacks layers), transposed when ``transpose``, and
    lands in rows ``rows`` of the parameter when several leaves pack into
    one (T5's q, k, v)."""

    name: str
    path: Tuple[str, ...]
    layer: Optional[int] = None
    transpose: bool = False
    rows: Optional[Tuple[int, int]] = None


def _clip_blocks(prefix: str, path: Tuple[str, ...], n: int):
    for i in range(n):
        p, b = f"{prefix}.{i}.", path + ("blocks",)
        for ln in ("ln_1", "ln_2"):
            yield Leaf(p + ln + ".weight", b + (ln, "w"), i)
            yield Leaf(p + ln + ".bias", b + (ln, "b"), i)
        for name, leaf, bias in (("attn.qkv", ("attn", "wqkv"), "bqkv"),
                                 ("attn.out", ("attn", "out"), "out_b"),
                                 ("mlp.fc", ("mlp", "fc"), "fc_b"),
                                 ("mlp.proj", ("mlp", "proj"), "proj_b")):
            yield Leaf(p + name + ".weight", b + leaf, i, transpose=True)
            yield Leaf(p + name + ".bias", b + (leaf[0], bias), i)


def clip_leaves(cfg: CLIPConfig) -> Iterator[Leaf]:
    """The CLIP towers' parameters (``clip.*``) with their places."""
    v, t = ("clip", "visual"), ("clip", "text")
    yield Leaf("clip.visual.conv1.weight", v + ("conv1",), transpose=True)
    yield Leaf("clip.visual.class_embedding", v + ("class_embedding",))
    yield Leaf("clip.visual.pos_embedding", v + ("pos_embedding",))
    for ln in ("ln_pre", "ln_post"):
        yield Leaf(f"clip.visual.{ln}.weight", v + (ln, "w"))
        yield Leaf(f"clip.visual.{ln}.bias", v + (ln, "b"))
    yield from _clip_blocks("clip.visual.blocks", v, cfg.vision_layers)
    yield Leaf("clip.visual.proj.weight", v + ("proj",), transpose=True)
    yield Leaf("clip.text.token_embedding", t + ("token_embedding",))
    yield Leaf("clip.text.pos_embedding", t + ("pos_embedding",))
    yield from _clip_blocks("clip.text.blocks", t, cfg.text_layers)
    yield Leaf("clip.text.ln_final.weight", t + ("ln_final", "w"))
    yield Leaf("clip.text.ln_final.bias", t + ("ln_final", "b"))
    yield Leaf("clip.text.text_projection.weight", t + ("text_projection",),
               transpose=True)
    yield Leaf("clip.logit_scale", ("clip", "logit_scale"))


def name_map(cfg: MPRGenConfig) -> Iterator[Leaf]:
    """Every parameter of :class:`MPRGen` under ``cfg`` with its place in
    the JAX tree."""
    yield from clip_leaves(cfg.clip)

    W = cfg.t5.inner_dim
    ff = (("wi_0", "wi_1", "wo") if cfg.t5.feed_forward_proj == "gated-gelu"
          else ("wi", "wo"))
    yield Leaf("t5.shared", ("t5", "shared"))
    for stack, n, attns, norms in (
            ("encoder", cfg.t5.num_layers, ("attn",), ("attn_ln", "ff_ln")),
            ("decoder", cfg.t5.num_decoder_layers,
             ("self_attn", "cross_attn"), ("self_ln", "cross_ln", "ff_ln"))):
        s = ("t5", stack)
        yield Leaf(f"t5.{stack}.rel_bias", s + ("rel_bias",))
        yield Leaf(f"t5.{stack}.final_ln", s + ("final_ln",))
        for i in range(n):
            p, b = f"t5.{stack}.block.{i}.", s + ("block",)
            for a in attns:
                for j, part in enumerate("qkv"):
                    yield Leaf(p + a + ".qkv", b + (a, part), i,
                               transpose=True, rows=(j * W, (j + 1) * W))
                yield Leaf(p + a + ".o.weight", b + (a, "o"), i,
                           transpose=True)
            for ln in norms:
                yield Leaf(p + ln, b + (ln,), i)
            for w in ff:
                yield Leaf(p + f"ff.{w}.weight", b + ("ff", w), i,
                           transpose=True)
    if cfg.needs_projection:
        yield Leaf("proj.weight", ("proj", "w"), transpose=True)
        yield Leaf("proj.bias", ("proj", "b"))
    if cfg.use_prediction_head:
        yield Leaf("head.weight", ("head", "w"), transpose=True)
        yield Leaf("head.bias", ("head", "b"))
    if cfg.use_ban:
        yield from _bcnet("ban.att.logits", ("ban", "att", "logits"), True)
        for g in range(cfg.glimpse):
            yield from _bcnet(f"ban.res.b_net.{g}",
                              ("ban", "res", "b_net", g), False)
            yield from _fcnet(f"ban.res.q_prj.{g}", ("ban", "res", "q_prj", g))
    if cfg.resnet is not None:
        yield from _resnet(cfg.resnet)
        yield Leaf("rn_proj.weight", ("rn_proj", "w"), transpose=True)
        yield Leaf("rn_proj.bias", ("rn_proj", "b"))
    if cfg.use_mapping:
        yield from _mapping("mapping.", ("mapping",))


def _mapping(prefix: str, path: Tuple) -> Iterator[Leaf]:
    for fc in ("fc1", "fc2"):
        yield Leaf(f"{prefix}{fc}.weight", path + (fc, "w"), transpose=True)
        yield Leaf(f"{prefix}{fc}.bias", path + (fc, "b"))
    yield Leaf(f"{prefix}logit_scale", path + ("logit_scale",))


# the leaves of a mapping checkpoint (``train/checkpoint.save_mapping``):
# the ``mapping`` subtree alone, at the root
MAPPING_LEAVES = tuple(_mapping("", ()))


def _resnet(cfg: ResNetConfig) -> Iterator[Leaf]:
    def bn(name: str, path: Tuple) -> Iterator[Leaf]:
        for part, leaf in (("weight", "w"), ("bias", "b"), ("mean", "mean"),
                           ("var", "var")):
            yield Leaf(f"{name}.{part}", path + (leaf,))

    def convs(prefix: str, path: Tuple) -> Iterator[Leaf]:
        for i in (1, 2, 3):
            yield Leaf(f"{prefix}.conv{i}", path + (f"conv{i}",))
            yield from bn(f"{prefix}.bn{i}", path + (f"bn{i}",))

    r = ("clip_rn",)
    yield from convs("clip_rn", r)
    for li, bi, cin, cmid, stride in blocks(cfg):
        p, b = f"clip_rn.layer{li + 1}.{bi}", r + (f"layer{li + 1}", bi)
        yield from convs(p, b)
        if has_downsample(cin, cmid, stride):
            yield Leaf(f"{p}.downsample.conv", b + ("downsample", "conv"))
            yield from bn(f"{p}.downsample.bn", b + ("downsample", "bn"))
    a = r + ("attnpool",)
    yield Leaf("clip_rn.attnpool.pos", a + ("pos",))
    for name in ("q", "k", "v", "out"):
        yield Leaf(f"clip_rn.attnpool.{name}.weight", a + (name, "w"),
                   transpose=name == "out")
        yield Leaf(f"clip_rn.attnpool.{name}.bias", a + (name, "b"))


def _fcnet(prefix: str, path: Tuple) -> Iterator[Leaf]:
    """A one-layer FCNet (every FCNet of the BAN fusion has one)."""
    p = path + (0,)
    yield Leaf(f"{prefix}.0.v", p + ("v",), transpose=True)
    yield Leaf(f"{prefix}.0.g", p + ("g",))
    yield Leaf(f"{prefix}.0.b", p + ("b",))


def _bcnet(prefix: str, path: Tuple, glimpses: bool) -> Iterator[Leaf]:
    yield from _fcnet(f"{prefix}.v_net", path + ("v_net",))
    yield from _fcnet(f"{prefix}.q_net", path + ("q_net",))
    if glimpses:
        yield Leaf(f"{prefix}.h_mat.v", path + ("h_mat", "v"))
        yield Leaf(f"{prefix}.h_mat.g", path + ("h_mat", "g"))
        yield Leaf(f"{prefix}.h_bias", path + ("h_bias",))


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # ascontiguousarray makes a 0-d array 1-d (the BAN fusion's scalar g)
    a = np.ascontiguousarray(x).reshape(np.shape(x))
    if not a.flags.writeable:  # e.g. a view of a device array
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _get(tree, path):
    for part in path:
        if isinstance(part, int) and isinstance(tree, dict):
            part = str(part)  # a list flattened to an npz and read back
        tree = tree[part]
    return tree


def tensors_from_jax(tree: Dict[str, Any], cfg: Optional[MPRGenConfig],
                     leaves: Optional[Iterable[Leaf]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A JAX-layout tree (params, or one AdamW moment tree) as tensors by
    the port's parameter names; over ``leaves`` in place of
    ``name_map(cfg)`` when given."""
    out: Dict[str, torch.Tensor] = {}
    packed: Dict[str, list] = {}
    for leaf in name_map(cfg) if leaves is None else leaves:
        x = _tensor(_get(tree, leaf.path))
        if leaf.layer is not None:
            x = x[leaf.layer]
        if leaf.transpose:
            x = x.transpose(-1, -2)
        if leaf.rows is None:
            out[leaf.name] = x
        else:
            packed.setdefault(leaf.name, []).append(x)
    for name, parts in packed.items():
        out[name] = torch.cat(parts, dim=0)
    for name in out:
        if name.endswith("logit_scale"):
            out[name] = out[name].reshape(())
    return out


def tensors_to_jax(tensors: Dict[str, torch.Tensor],
                   cfg: Optional[MPRGenConfig],
                   leaves: Optional[Iterable[Leaf]] = None) -> Dict[str, Any]:
    """The reverse of :func:`tensors_from_jax`: a JAX-layout tree of CPU
    tensors (layers stacked on axis 0, dense kernels (in, out))."""
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for leaf in name_map(cfg) if leaves is None else leaves:
        x = tensors[leaf.name].detach().cpu()
        if leaf.rows is not None:
            x = x[leaf.rows[0]:leaf.rows[1]]
        if leaf.transpose:
            x = x.transpose(-1, -2)
        if leaf.layer is None:
            stacks[leaf.path] = x.contiguous()
        else:
            stacks.setdefault(leaf.path, []).append(x)
    for path, x in stacks.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.stack(x) if isinstance(x, list) else x
    return _lists(tree)


def _lists(tree):
    """Nodes keyed 0..n-1 (the BAN fusion's layers) as lists, as the JAX
    package builds them."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def tree_numpy(tree):
    """A tree of tensors as numpy arrays (bf16 as ``ml_dtypes.bfloat16``,
    imported only then), e.g. to hand :func:`params_to_jax` to JAX."""
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_numpy(v) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    if tree.dtype == torch.bfloat16:
        import ml_dtypes

        return tree.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return tree.numpy()


def params_from_jax(tree: Dict[str, Any], cfg: MPRGenConfig,
                    device: Optional[torch.device] = None) -> MPRGen:
    """The JAX package's params pytree (``init_mprgen`` / a loaded
    checkpoint) as the port's :class:`MPRGen` module."""
    model = MPRGen(cfg)
    tensors = tensors_from_jax(tree, cfg)
    pos = tensors.get("clip_rn.attnpool.pos")
    if pos is not None:
        # the attention pool's table is the file's: RN50x4's is for 288 px
        # (82 rows) while the tower runs at the ViT's 224 px; only
        # ``resnet_encode_image`` reads it (and raises on a mismatch)
        model.clip_rn.attnpool.pos = torch.nn.Parameter(
            torch.empty(pos.shape))
    model.load_state_dict(tensors, strict=True)
    return model.to(device) if device is not None else model


def params_to_jax(params: MPRGen, cfg: MPRGenConfig) -> Dict[str, Any]:
    """The port's parameters as the JAX package's params pytree (CPU
    tensors; :func:`tree_numpy` for numpy leaves)."""
    return tensors_to_jax(dict(params.named_parameters()), cfg)


def mapping_from_jax(tree: Dict[str, Any],
                     device: Optional[torch.device] = None) -> Mapping:
    """A JAX ``init_mapping`` tree (``create_mapping``'s checkpoint) as the
    port's :class:`~models.mprgen.Mapping`."""
    tensors = tensors_from_jax(tree, None, MAPPING_LEAVES)
    model = Mapping(tensors["fc1.weight"].shape[0])
    model.load_state_dict(tensors, strict=True)
    return model.to(device) if device is not None else model


def mapping_to_jax(mapping: Mapping) -> Dict[str, Any]:
    return tensors_to_jax(dict(mapping.named_parameters()), None,
                          MAPPING_LEAVES)


def opt_state_from_jax(opt: Dict[str, Any], cfg: MPRGenConfig,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, Any]:
    """The JAX ``adamw_init`` / ``adamw_update`` state as the port's
    (``train/optim.py``): moments by parameter name, ``step`` an int."""
    def moments(tree):
        return {k: v.contiguous().to(device).clone()
                for k, v in tensors_from_jax(tree, cfg).items()}

    return {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
            "step": int(np.asarray(opt["step"]))}


def opt_state_to_jax(state: Dict[str, Any],
                     cfg: MPRGenConfig) -> Dict[str, Any]:
    """The port's AdamW state as the JAX package's pytree."""
    return {"mu": tensors_to_jax(state["mu"], cfg),
            "nu": tensors_to_jax(state["nu"], cfg),
            "step": torch.tensor(state["step"], dtype=torch.int32)}

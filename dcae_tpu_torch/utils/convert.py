"""Weight conversion into the port's state dict.

The port's parameter names and layouts ARE the reference's torch state
dict (g_a.0..6, g_s.0..6, h_a.0..2, h_z_s{1,2}.0..2, dt,
dt_cross_attention.{i}, cc_mean_transforms.{i}, cc_scale_transforms.{i},
lrp_transforms.{i}, entropy_bottleneck._matrix{i}/_bias{i}/_factor{i}/
quantiles), so:

  * `state_dict_from_flax` turns a JAX-package parameter tree (NHWC Flax
    layout, numpy leaves) into that state dict;
  * `clean_reference_state_dict` takes a reference .pth state dict as it is
    and drops only the entropy-coding buffers (which the port rebuilds in
    update()).

Either result loads with `model.load_state_dict(sd, strict=True)`.

Layout transforms (Flax -> torch):
  Dense kernel  (in, out)        -> Linear weight (out, in)
  Conv kernel   (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  Deconv kernel (kh, kw, in, out) -> ConvTranspose2d weight (in, out, kh,
                                     kw), spatially flipped
  LayerNorm scale / bias         -> weight / bias
  scanned Swin pairs (leading axis p) -> layers.{2p} (W), layers.{2p+1} (SW)
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Tree = Dict


def _linear(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _deconv(w) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _index(tree, i: int):
    """One slice of a stacked (scanned) subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


class FlaxToTorch:
    """Emits torch state-dict entries from Flax subtrees, one method per
    module kind; `out` collects {name: ndarray}. state_dict_from_flax walks
    the whole model; the tests convert single blocks with it."""

    def __init__(self):
        self.out: Dict[str, np.ndarray] = {}

    def put(self, name, value):
        self.out[name] = np.ascontiguousarray(np.asarray(value))

    def linear(self, dst, node):          # node: {"dense": {kernel, bias}}
        self.put(f"{dst}.weight", _linear(node["dense"]["kernel"]))
        if "bias" in node["dense"]:
            self.put(f"{dst}.bias", node["dense"]["bias"])

    def conv(self, dst, node):            # node: {"conv": {kernel, bias}}
        self.put(f"{dst}.weight", _conv(node["conv"]["kernel"]))
        if "bias" in node["conv"]:
            self.put(f"{dst}.bias", node["conv"]["bias"])

    def deconv(self, dst, node):          # node: {kernel, bias}
        self.put(f"{dst}.weight", _deconv(node["kernel"]))
        if "bias" in node:
            self.put(f"{dst}.bias", node["bias"])

    def ln(self, dst, node):
        self.put(f"{dst}.weight", node["ln"]["scale"])
        self.put(f"{dst}.bias", node["ln"]["bias"])

    def rbb(self, dst, node):
        for c in ("conv1", "conv2", "conv3", "skip"):
            if c in node:
                self.conv(f"{dst}.{c}", node[c])

    def rbb_stride(self, dst, node):
        self.conv(f"{dst}.conv", node["down"])
        for i in (1, 2, 3):
            self.rbb(f"{dst}.res{i}", node[f"res{i}"])

    def rbb_upsample(self, dst, node):
        for i in (1, 2, 3):
            self.rbb(f"{dst}.res{i}", node[f"res{i}"])
        self.deconv(f"{dst}.conv", node["up"])

    def conv_glu(self, dst, node):
        self.linear(f"{dst}.fc1", node["fc1"])
        self.linear(f"{dst}.fc2", node["fc2"])
        self.conv(f"{dst}.dwconv.dwconv", node["dwconv"]["dw"])

    def swin_block(self, dst, node):
        self.ln(f"{dst}.ln1", node["ln1"])
        self.ln(f"{dst}.ln2", node["ln2"])
        msa = node["msa"]
        self.put(f"{dst}.msa.embedding_layer.weight",
                 _linear(msa["qkv_kernel"]))
        self.put(f"{dst}.msa.embedding_layer.bias", msa["qkv_bias"])
        self.put(f"{dst}.msa.linear.weight", _linear(msa["proj_kernel"]))
        self.put(f"{dst}.msa.linear.bias", msa["proj_bias"])
        self.put(f"{dst}.msa.relative_position_params",
                 msa["relative_position"])
        self.conv_glu(f"{dst}.mlp", node["mlp"])
        self.put(f"{dst}.res_scale_1.scale", node["res_scale_1"]["scale"])
        self.put(f"{dst}.res_scale_2.scale", node["res_scale_2"]["scale"])

    def swin_stack(self, dst, node, block_num):
        if "pairs" in node:               # scanned (W, SW) pairs
            for p in range(block_num // 2):
                pair = _index(node["pairs"], p)
                self.swin_block(f"{dst}.layers.{2 * p}", pair["w"])
                self.swin_block(f"{dst}.layers.{2 * p + 1}", pair["sw"])
        else:
            for i in range(block_num):
                self.swin_block(f"{dst}.layers.{i}", node[f"block{i}"])
        self.conv(f"{dst}.conv", node["conv"])

    def dict_attention(self, dst, node):
        self.linear(f"{dst}.x_trans", node["x_trans"])
        self.ln(f"{dst}.ln_scale", node["ln_scale"])
        m = node["msa"]
        self.conv(f"{dst}.msa.s", m["s"])
        for j in range(3):
            layer = m["dense"][f"layer{j}"]
            for c in ("in_trans", "dw_conv", "out_trans"):
                self.conv(f"{dst}.msa.dense.conv_layers.{j}.1.{c}", layer[c])
        self.conv(f"{dst}.msa.dense.proj", m["dense"]["proj"])
        self.conv(f"{dst}.msa.spatial_atte.conv1", m["spatial"]["conv"])
        self.ln(f"{dst}.lnx", node["lnx"])
        self.linear(f"{dst}.q_trans", node["q_trans"])
        self.ln(f"{dst}.dict_ln", node["dict_ln"])
        self.linear(f"{dst}.k", node["k"])
        self.linear(f"{dst}.linear", node["linear"])
        self.ln(f"{dst}.ln_mlp", node["ln_mlp"])
        self.conv_glu(f"{dst}.mlp", node["mlp"])
        self.linear(f"{dst}.output_trans.0", node["output_trans"])
        self.put(f"{dst}.scale", node["scale"])
        for i in (1, 2, 3):
            self.put(f"{dst}.res_scale_{i}.scale",
                     node[f"res_scale_{i}"]["scale"])

    def slice_net(self, dst, node):
        for j, idx in enumerate((0, 2, 4)):
            self.conv(f"{dst}.{idx}", node[f"conv{j}"])

    def hyper_synthesis(self, dst, node):
        self.deconv(f"{dst}.0", node["up0"])
        self.swin_stack(f"{dst}.1", node["swin"], 1)
        self.rbb_upsample(f"{dst}.2", node["up1"])


def state_dict_from_flax(params: Tree, cfg) -> Dict[str, np.ndarray]:
    """The port's (= the reference's) state dict from a JAX-package Flax
    parameter tree with numpy (or array-like) leaves."""
    e = FlaxToTorch()
    p = params
    g_a, g_s, h_a = p["g_a"], p["g_s"], p["h_a"]
    e.rbb_stride("g_a.0", g_a["down0"])
    e.swin_stack("g_a.1", g_a["swin1"], cfg.block_num[0])
    e.rbb_stride("g_a.2", g_a["down1"])
    e.swin_stack("g_a.3", g_a["swin2"], cfg.block_num[1])
    e.rbb_stride("g_a.4", g_a["down2"])
    e.swin_stack("g_a.5", g_a["swin3"], cfg.block_num[2])
    e.conv("g_a.6", g_a["down3"])

    e.deconv("g_s.0", g_s["up0"])
    e.swin_stack("g_s.1", g_s["swin1"], cfg.block_num[2])
    e.rbb_upsample("g_s.2", g_s["up1"])
    e.swin_stack("g_s.3", g_s["swin2"], cfg.block_num[1])
    e.rbb_upsample("g_s.4", g_s["up2"])
    e.swin_stack("g_s.5", g_s["swin3"], cfg.block_num[0])
    e.rbb_upsample("g_s.6", g_s["up3"])

    e.rbb_stride("h_a.0", h_a["down0"])
    e.swin_stack("h_a.1", h_a["swin"], 1)
    e.conv("h_a.2", h_a["down1"])
    for name in ("h_z_s1", "h_z_s2"):
        e.hyper_synthesis(name, p[name])

    e.put("dt", p["dt"])
    for i in range(cfg.num_slices):
        e.dict_attention(f"dt_cross_attention.{i}",
                         p[f"dt_cross_attention_{i}"])
        e.slice_net(f"cc_mean_transforms.{i}", p[f"cc_mean_transforms_{i}"])
        e.slice_net(f"cc_scale_transforms.{i}",
                    p[f"cc_scale_transforms_{i}"])
        e.slice_net(f"lrp_transforms.{i}", p[f"lrp_transforms_{i}"])

    eb = p["entropy_bottleneck"]
    n_filters = len(cfg.eb_filters)
    for i in range(n_filters + 1):
        e.put(f"entropy_bottleneck._matrix{i}", eb[f"matrix_{i}"])
        e.put(f"entropy_bottleneck._bias{i}", eb[f"bias_{i}"])
        if i < n_filters:
            e.put(f"entropy_bottleneck._factor{i}", eb[f"factor_{i}"])
    e.put("entropy_bottleneck.quantiles", eb["quantiles"])
    return e.out


# the reference's entropy-coding buffers: rebuilt by update(), not loaded
_CODING_BUFFERS = ("_quantized_cdf", "_offset", "_cdf_length", "scale_table",
                   "_medians", "target", "likelihood_lower_bound",
                   "lower_bound_scale", "lower_bound")


def clean_reference_state_dict(sd: Dict) -> Dict:
    """A reference checkpoint's state dict, ready for a strict load: the
    {'state_dict': ...} wrapper and DDP 'module.' prefixes removed, split
    compress_model./decompress_model. checkpoints collapsed (compress side
    wins for shared modules), entropy-coding buffers dropped."""
    sd = sd.get("state_dict", sd)
    flat: Dict = {}
    # decompress_model. entries last, so the compress side's copy is kept
    items = sorted(sd.items(),
                   key=lambda kv: "decompress_model." in kv[0])
    for k, v in items:
        if k.startswith("module."):
            k = k[len("module."):]
        for prefix in ("compress_model.", "decompress_model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        if any(part in _CODING_BUFFERS for part in k.split(".")):
            continue
        flat.setdefault(k, v)
    return flat

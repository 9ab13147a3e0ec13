"""The port's TCP bitstream service on the CPU (tiny config): the wire
protocol against the JAX package's both ways (a 300,000-byte payload, so
that the receive is chunked; a header without its terminator), the port's
tools/server.py --decode decoding on arrival a classic .bin and a DTI2
file written by the JAX package's CLI (the classic container byte for byte
the port client's, each decode within 0.05 dB PSNR of the JAX decode: the
bars of tests/test_torch_clis.py), and the port's tools/client.py end to
end against that server.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dcae_tpu.config import DCAEConfig as JaxConfig
from dcae_tpu.models.codec import DCAECodec as JaxCodec
from dcae_tpu.runtime import service as jservice
from dcae_tpu.utils.convert import convert_reference_state_dict
from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.models.dcae import DCAE
from dcae_tpu_torch.runtime import container, service
from dcae_tpu_torch.tools import client
from dcae_tpu_torch.tools._cli import load_codec
from dcae_tpu_torch.train.state import create_train_state, make_optimizer
from dcae_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOAD = np.random.default_rng(3).integers(
    0, 256, 300_000, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _serve(server_cls, out_dir):
    """A background server of `server_cls` on a free port; returns (server,
    {name: payload}, an event set at each payload)."""
    got = {}
    done = threading.Event()

    def on_payload(name, data):
        got[name] = data
        done.set()

    srv = server_cls(0, out_dir, on_payload)
    srv.start(background=True)
    return srv, got, done


@pytest.mark.parametrize("sender,server", [
    ("port", "jax"), ("jax", "port")])
def test_wire_parity(tmp_path, sender, server):
    send = {"port": service.send_bytes, "jax": jservice.send_bytes}[sender]
    cls = {"port": service.BitstreamServer,
           "jax": jservice.BitstreamServer}[server]
    srv, got, done = _serve(cls, str(tmp_path))
    try:
        send("blob.bin", PAYLOAD, "127.0.0.1", srv.bound_port)
        assert done.wait(30)
    finally:
        srv.stop()
    assert got == {"blob.bin": PAYLOAD}
    with open(tmp_path / "received_blob.bin", "rb") as f:
        assert f.read() == PAYLOAD


def test_header_without_terminator(tmp_path):
    """The reference's own client sends 'name|size' with no newline: the
    port's server parses it after its drain window and ACKs."""
    srv, got, done = _serve(service.BitstreamServer, str(tmp_path))
    try:
        with socket.create_connection(("127.0.0.1", srv.bound_port),
                                      timeout=30) as s:
            s.sendall(f"raw.bin|{len(PAYLOAD)}".encode())
            assert s.recv(16) == b"ACK"
            s.sendall(PAYLOAD)
        assert done.wait(30)
    finally:
        srv.stop()
    assert got == {"raw.bin": PAYLOAD}


def test_server_survives_a_bad_client(tmp_path):
    srv, got, done = _serve(service.BitstreamServer, str(tmp_path))
    try:
        with socket.create_connection(("127.0.0.1", srv.bound_port),
                                      timeout=30) as s:
            s.sendall(b"short.bin|100\n")
            assert s.recv(16) == b"ACK"
            s.sendall(b"only ten b")          # then hang up
        service.send_bytes("ok.bin", b"fine", "127.0.0.1", srv.bound_port)
        assert done.wait(30)
    finally:
        srv.stop()
    assert got == {"ok.bin": b"fine"}
    assert not os.path.exists(tmp_path / "received_short.bin")


# ------------------------------------------------- decode on arrival --

def _read_png(path: str, seconds: float = 60) -> np.ndarray:
    """The PNG the server writes, once it is there whole."""
    end = time.time() + seconds
    while True:
        try:
            with Image.open(path) as im:
                return np.asarray(im, np.float64)
        except (OSError, SyntaxError):
            if time.time() > end:
                raise
            time.sleep(0.05)


def _psnr(png: str, src: str) -> float:
    a = _read_png(png)
    b = np.asarray(Image.open(src), np.float64)
    return 10 * np.log10(255.0 ** 2 / np.mean((a - b) ** 2))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One seeded tiny init as a checkpoint of each package, a PNG, the
    JAX CLI's classic and interleaved files of it, and the port's
    tools/server.py --decode on them (a subprocess, on the CPU)."""
    from tools.compress_and_decompress import compress_dir, decompress_dir

    d = tmp_path_factory.mktemp("serve")
    img_dir = d / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 1, (192 // 16, 256 // 16, 3))
    img = np.clip(np.kron(base, np.ones((16, 16, 1)))
                  + rng.normal(0, 0.02, (192, 256, 3)), 0, 1)
    Image.fromarray((img * 255).astype(np.uint8)).save(str(img_dir / "im.png"))

    model = DCAE(DCAEConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    port_ck = str(d / "port.ckpt")
    save_checkpoint(port_ck, create_train_state(model, make_optimizer(1e-4),
                                                torch.Generator()), 1, 2.0)
    params = convert_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        JaxConfig.tiny())
    jcodec = JaxCodec(JaxConfig.tiny(), params=jax.tree.map(np.asarray,
                                                            params))
    jcodec.update()
    for fmt, kw in (("classic", {}), ("interleaved", {"interleaved": True})):
        compress_dir(jcodec, str(img_dir), str(d / fmt), **kw)
        decompress_dir(jcodec, str(d / fmt / "bin"), str(d / fmt))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(d / "recv")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcae_tpu_torch.tools.server", "--port",
         str(port), "--out", out, "--decode", "--checkpoint", port_ck,
         "--tiny", "--device", "cpu"], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        end = time.time() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                if proc.poll() is not None or time.time() > end:
                    raise RuntimeError(proc.communicate()[0])
                time.sleep(0.1)
        yield {"dir": d, "img": str(img_dir / "im.png"), "port": port,
               "out": out, "port_ck": port_ck}
    finally:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("fmt", ["classic", "interleaved"])
def test_server_decodes_jax_files_on_arrival(served, fmt):
    raw_path = os.path.join(served["dir"], fmt, "bin", "im.bin")
    with open(raw_path, "rb") as f:
        raw = f.read()
    if fmt == "interleaved":
        assert raw[:4] == b"DTI2" and container.is_interleaved_bin(raw)
    else:
        # the JAX CLI's classic container is the port client's, bytes and
        # all
        codec = load_codec(DCAEConfig.tiny(), served["port_ck"], "cpu")
        try:
            assert client.encode_image(codec, served["img"]) == \
                ("im.bin", raw)
        finally:
            codec.close()
    name = f"{fmt}_im.bin"
    # the JAX client's send_bytes to the port's server
    jservice.send_bytes(name, raw, "127.0.0.1", served["port"])
    png = os.path.join(served["out"], f"{fmt}_im.png")
    got = _psnr(png, served["img"])
    with open(os.path.join(served["out"], f"received_{name}"), "rb") as f:
        assert f.read() == raw
    want = _psnr(os.path.join(served["dir"], fmt, "png", "im.png"),
                 served["img"])
    assert abs(got - want) <= 0.05


def test_client_end_to_end(served, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(served["img"], str(data / "cl.png"))
    client.main(["--data", str(data), "--host", "127.0.0.1", "--port",
                 str(served["port"]), "--checkpoint", served["port_ck"],
                 "--tiny", "--device", "cpu"])
    got = _psnr(os.path.join(served["out"], "cl.png"), served["img"])
    codec = load_codec(DCAEConfig.tiny(), served["port_ck"], "cpu")
    try:
        _, payload = client.encode_image(codec, str(data / "cl.png"))
    finally:
        codec.close()
    with open(os.path.join(served["out"], "received_cl.bin"), "rb") as f:
        assert f.read() == payload
    want = _psnr(os.path.join(served["dir"], "classic", "png", "im.png"),
                 served["img"])
    assert abs(got - want) <= 0.05

"""The train state on a model mesh in the port: gradient compression in the
ZeRO-1 blocks and sharded checkpoints, on the CPU.

A mesh here names the CPU at every position (``make_mesh(shape, axes,
"cpu")``). Checked:

- ``grad_compress.compress`` of gradients placed as the parameters and an
  error state placed by ``zero1_shardings`` equals, bit for bit, the
  unsharded ``compress`` of the gathered trees, for ``topk`` and ``int8``:
  the compressed gradients and the new error state, on (2, 1), (1, 2),
  (2, 2), (1, 4), (4, 1) and (1, 8). The gradients and the errors sit on
  a binary grid, so many values tie at the threshold; the tree holds stacked
  groups across list entries and a leaf the data width does not divide,
  whose error state is then replicated at every position. (g) Counting a
  replicated block at every holder moves the threshold; (h) pairing an
  error block with another slice of the gradient block changes the result:
  each is shown to break the equality.
- The train step with compression on a mesh against the unsharded step:
  the loss, ``compress_ratio`` and ``grad_norm`` within ``REL``, the
  parameters within ``ZERO1_ATOL`` (int8: but for at most 1e-4 of the
  elements, which a rounding difference moves to a neighbouring level, each
  within 2 lr a step).
- ``checkpoint.save`` of a (2, 2) state writes the same files, byte for
  byte, as ``save`` of the gathered state; ``restore`` brings it back onto
  (2, 2), onto (1, 4) and unsharded, from ``Sharded`` leaves and from
  ``meta`` specs with ``train_state_shardings``, every leaf placed from the
  host; ZeRO-1 steps after a restore on the same mesh equal the
  uninterrupted run bit for bit, and after a restore on (1, 4) or unsharded
  within ``ZERO1_ATOL``. Without zstd a shard's zlib stream is written on
  threads (``compression.compress`` with a pool), and both packages read it;
  up to 16 MiB it is ``zlib.compress``'s stream byte for byte.
"""
import filecmp
import os
import zlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import activate_mesh, make_mesh
from repro_torch.launch.sharding import (Sharded, gather_tree,
                                         param_shardings, place_tree,
                                         zero1_shardings)
from repro_torch.models import get_model, make_batch
from repro_torch.runtime import checkpoint
from repro_torch.training import grad_compress, optimizer
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             shard_train_state,
                                             train_state_shardings,
                                             train_state_specs)
from repro_torch.tree import leaves, map_tree

F32 = dict(dtype="float32", param_dtype="float32")
AXES2 = ("data", "model")
REL = 1e-5          # the port on a mesh against the port unsharded
ZERO1_ATOL = 1e-4   # the ZeRO-1 steps' parameters, sharded against
#                     unsharded: AdamW moves an element whose gradient is
#                     near its eps (1e-8) by up to the learning rate on a
#                     rounding difference
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4), (4, 1), (1, 8))
METHODS = ("topk", "int8")
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops a position: one intra-op thread keeps them off the
    thread pool, which several test workers on one host would
    oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return make_mesh(shape, AXES2, "cpu")


def _tree(seed=0):
    """Gradients and an error state of a tree shaped as a model's: ``wq``
    and ``wo`` stacked over two layers (one group each), an ``embed``, and
    a 17-wide ``gain`` that no data width divides, so its error state is
    replicated. The gradients are multiples of 1/8 and the errors of 1/64,
    so their sums are exact and many tie; the gain holds the largest
    ones."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.round(8 * scale * torch.randn(shape, generator=g)) / 8

    grads = {"embed": rnd(16, 8),
             "gain": rnd(17, scale=20.0),
             "layers": [{"attn": {"wq": rnd(8, 16), "wo": rnd(16, 8)}}
                        for _ in range(2)]}
    err = map_tree(lambda t: torch.round(torch.randn(t.shape, generator=g))
                   / 64, grads)
    return grads, err


def _on_mesh(grads, err, mesh):
    return (place_tree(grads, mesh, param_shardings(mesh, grads)),
            place_tree(err, mesh, zero1_shardings(mesh, err)))


def _same_bits(got, want):
    return all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", MESHES)
def test_compression_on_a_mesh_equals_the_unsharded_bit_for_bit(shape,
                                                               method):
    grads, err = _tree()
    mesh = cpu_mesh(shape)
    sg, se = _on_mesh(grads, err, mesh)
    assert len(se["gain"].holders()[0]) > 1     # replicated
    want_c, want_e, want_m = grad_compress.compress(grads, err, method=method)
    got_c, got_e, got_m = grad_compress.compress(sg, se, method=method)
    for a, e in zip(leaves(got_c), leaves(se)):
        assert isinstance(a, Sharded) and a.spec == e.spec
    assert _same_bits(gather_tree(got_c), want_c)
    assert _same_bits(gather_tree(got_e), want_e)
    assert float(got_m["compress_ratio"]) == float(want_m["compress_ratio"])
    if method == "topk":
        # ties: more kept than k in some group
        kept = sum(int((c != 0).sum()) for c in leaves(want_c))
        n = sum(c.numel() for c in leaves(want_c))
        assert kept > int(0.125 * n)


@pytest.mark.parametrize("chunk", [None, 5])
def test_the_threshold_is_the_kth_largest_bit_for_bit(chunk, monkeypatch):
    """The radix select's threshold is ``torch.topk``'s k-th value itself,
    for each stacked group, on (2, 2), (1, 8) and (4, 1); also with runs of
    5 keys (blocks cut into pieces, many runs a device)."""
    if chunk is not None:
        monkeypatch.setattr(grad_compress, "_CHUNK", chunk)
    grads, err = _tree(1)
    g32 = [g + e for g, e in zip(leaves(grads), leaves(err))]
    groups = grad_compress.stacked_groups(grads)
    for shape in ((2, 2), (1, 8), (4, 1)):
        mesh = cpu_mesh(shape)
        sg, se = _on_mesh(grads, err, mesh)
        blocks = [Sharded(e.mesh, e.spec, e.shape, [
            g.parts[p][optimizer.within(e.region(p), g.region(p))]
            + e.parts[p] for p in range(mesh.size)])
            for g, e in zip(leaves(sg), leaves(se))]
        got = grad_compress._thresholds(blocks, groups, 0.125)
        for j, idx in enumerate(groups):
            flat = torch.cat([g32[i].reshape(-1) for i in idx]).abs()
            want = torch.topk(flat, max(int(flat.numel() * 0.125),
                                        1)).values[-1]
            assert got[j].view(torch.int32) == want.view(torch.int32), j


def test_a_replicated_block_counts_once():
    """(g) The gain's error state is replicated at every position: counted
    at every holder, its largest value alone fills the top k (2 of 17) of
    its group and the threshold moves up to it."""
    grads, err = _tree()
    mesh = cpu_mesh((2, 2))
    sg, se = _on_mesh(grads, err, mesh)
    want = grad_compress.compress(grads, err, method="topk")
    real = grad_compress._owned
    try:
        grad_compress._owned = lambda x: list(range(x.mesh.size))
        wrong = grad_compress.compress(sg, se, method="topk")
    finally:
        grad_compress._owned = real
    assert not _same_bits(gather_tree(wrong[0]), want[0])


def test_each_error_block_pairs_with_its_own_gradient_slice():
    """(h) The error state splits the parameters' blocks over the data
    axes: each position adds its error block to the slice of its gradient
    block at the same place. Paired with the block's first slice instead,
    the sums, and so the result, change."""
    grads, err = _tree()
    mesh = cpu_mesh((2, 2))
    sg, se = _on_mesh(grads, err, mesh)
    want = grad_compress.compress(grads, err, method="int8")
    real = grad_compress.within
    try:
        grad_compress.within = lambda inner, outer: tuple(
            slice(0, a.stop - a.start) for a in inner)
        wrong = grad_compress.compress(sg, se, method="int8")
    finally:
        grad_compress.within = real
    assert not _same_bits(gather_tree(wrong[1]), want[1])


def _cfg():
    return get_smoke_config("whisper_base").replace(**F32)


def _batches(cfg, n, seed=0):
    return [make_batch(cfg, "train", B, S, seed + i, device="cpu")
            for i in range(n)]


@pytest.mark.parametrize("method", METHODS)
def test_compressed_train_steps_on_a_mesh_equal_unsharded(method):
    cfg = _cfg()
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3,
                       grad_compression=method)
    start = init_train_state(model, tcfg, 0, device="cpu")
    mesh = cpu_mesh((2, 2))
    state = shard_train_state(optimizer.clone_tree(start), mesh, cfg)
    plain = optimizer.clone_tree(start)
    step = make_train_step(model, tcfg)
    lrs = []
    for i, b in enumerate(_batches(cfg, 3)):
        with activate_mesh(mesh):
            state, m = step(state, b)
        plain, m0 = step(plain, b)
        lrs.append(float(m0["lr"]))
        assert set(m) == set(m0)
        for k in ("loss", "grad_norm", "compress_ratio"):
            a, c = float(m[k]), float(m0[k])
            assert abs(a - c) <= REL * abs(c), (i, k, a, c)
    assert isinstance(state["err"]["embed"], Sharded)
    got = gather_tree(state, "cpu")
    gap = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        leaves(got["params"]), leaves(plain["params"]))])
    if method == "topk":
        assert gap.max().item() <= ZERO1_ATOL, gap.max().item()
        return
    # int8 rounds g / scale to the nearest level: where the sharded and the
    # unsharded gradients, a rounding apart, straddle a half level, the
    # element takes the neighbouring level, and AdamW moves it by up to
    # about 2 lr a step more (1 of the 198144 elements here)
    far = gap > ZERO1_ATOL
    assert int(far.sum()) <= 1e-4 * gap.numel(), int(far.sum())
    assert gap.max().item() <= 2 * sum(lrs), gap.max().item()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A (2, 2) run with topk compression: the state after two steps saved
    on the mesh and, gathered, unsharded; the third step's batch and the
    uninterrupted third step's state."""
    cfg = _cfg()
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3,
                       grad_compression="topk")
    mesh = cpu_mesh((2, 2))
    state = shard_train_state(init_train_state(model, tcfg, 0, device="cpu"),
                              mesh, cfg)
    step = make_train_step(model, tcfg)
    batches = _batches(cfg, 3, seed=5)
    for b in batches[:2]:
        with activate_mesh(mesh):
            state, _ = step(state, b)
    root = tmp_path_factory.mktemp("ckpt")
    sharded_dir = checkpoint.save(str(root / "mesh"), 2, state)
    plain_dir = checkpoint.save(str(root / "plain"), 2,
                                gather_tree(state, "cpu"))
    after_save = optimizer.clone_tree(state)
    with activate_mesh(mesh):
        state, _ = step(state, batches[2])
    return dict(cfg=cfg, model=model, tcfg=tcfg, mesh=mesh, root=root,
                sharded_dir=sharded_dir, plain_dir=plain_dir,
                at_save=after_save, batch=batches[2], final=state)


def test_a_mesh_checkpoint_is_byte_identical_to_the_unsharded_save(run):
    a, b = run["sharded_dir"], run["plain_dir"]
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "manifest.json" in names and len(names) > 2
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def _parts(tree):
    return [t for x in leaves(tree) for t in x.parts]


@pytest.mark.parametrize("source", ["sharded", "specs"])
def test_restore_onto_the_same_mesh_continues_bit_for_bit(run, source):
    mesh = run["mesh"]
    if source == "sharded":
        state, _ = checkpoint.restore(str(run["root"] / "mesh"),
                                      run["at_save"])
    else:
        specs = train_state_specs(run["model"], run["tcfg"])
        state, _ = checkpoint.restore(
            str(run["root"] / "mesh"), specs,
            shardings=train_state_shardings(mesh, specs, run["cfg"]))
    for got, want in zip(leaves(state), leaves(run["at_save"])):
        assert isinstance(got, Sharded) and got.spec == want.spec
        assert all(torch.equal(a, b) for a, b in zip(got.parts, want.parts))
    with activate_mesh(mesh):
        state, _ = make_train_step(run["model"], run["tcfg"])(state,
                                                              run["batch"])
    assert all(torch.equal(a, b) for a, b in zip(_parts(state),
                                                 _parts(run["final"])))


@pytest.mark.parametrize("target", [(1, 4), None])
def test_restore_onto_another_mesh_or_none(run, target):
    """From ``meta`` specs with the target's shardings (every leaf placed
    from a host tensor), or unsharded into a CPU state; the ZeRO-1 moments
    and the error state take the target mesh's ``zero1_shardings``. The
    next step comes within ``ZERO1_ATOL`` of the uninterrupted one."""
    cfg, model, tcfg = run["cfg"], run["model"], run["tcfg"]
    placed = []
    real = checkpoint.place

    def recording(x, mesh, spec):
        placed.append(x.device.type)
        return real(x, mesh, spec)

    if target is None:
        like = init_train_state(model, tcfg, 1, device="cpu")
        state, _ = checkpoint.restore(str(run["root"] / "mesh"), like)
        step_mesh = None
    else:
        step_mesh = cpu_mesh(target)
        specs = train_state_specs(model, tcfg)
        sh = train_state_shardings(step_mesh, specs, cfg)
        checkpoint.place = recording
        try:
            state, _ = checkpoint.restore(str(run["root"] / "mesh"), specs,
                                          shardings=sh)
        finally:
            checkpoint.place = real
        assert placed and set(placed) == {"cpu"}
        assert len(placed) == len(leaves(specs))
        for name in ("m", "v"):
            for got, want in zip(leaves(state["opt"][name]),
                                 leaves(zero1_shardings(
                                     step_mesh, specs["opt"][name]))):
                assert got.spec == want.spec
        for got, want in zip(leaves(state["err"]),
                             leaves(zero1_shardings(step_mesh,
                                                    specs["err"]))):
            assert got.spec == want.spec
    whole = gather_tree(run["at_save"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(gather_tree(state, "cpu")), leaves(whole)))
    with activate_mesh(step_mesh):
        state, _ = make_train_step(model, tcfg)(state, run["batch"])
    got = gather_tree(state, "cpu")
    want = gather_tree(run["final"], "cpu")
    perr = max((a - b).abs().max().item() for a, b in zip(
        leaves(got["params"]), leaves(want["params"])))
    assert perr <= ZERO1_ATOL, perr
    assert int(got["opt"]["step"]) == 3


@pytest.mark.parametrize("n", [0, 7, (16 << 20) + 5])
def test_parallel_zlib_is_one_stream_that_both_packages_read(n,
                                                              monkeypatch):
    """Without zstd, a shard compresses in 16 MiB chunks on threads into one
    zlib stream, the same bytes as without threads and, up to 16 MiB, as
    ``zlib.compress``: ``zlib.decompress``, the port's and the JAX
    package's ``decompress`` read it."""
    from concurrent.futures import ThreadPoolExecutor

    from repro import compression as jax_compression
    from repro_torch import compression

    data = bytes(range(251)) * (n // 251) + bytes(n % 251)
    monkeypatch.setattr(compression, "_zstd", None)
    with ThreadPoolExecutor(3) as pool:
        blob = compression.compress(data, pool=pool)
    assert compression.compress(data) == blob
    if n <= 16 << 20:
        assert blob == compression.TAG_ZLIB + zlib.compress(data, 3)
    assert blob[:1] == compression.TAG_ZLIB
    assert zlib.decompress(blob[1:]) == data
    assert compression.decompress(blob) == data
    assert jax_compression.decompress(blob) == data


def test_meta_specs_without_shardings_are_refused(run):
    specs = train_state_specs(run["model"], run["tcfg"])
    with pytest.raises(ValueError, match="shardings"):
        checkpoint.restore(str(run["root"] / "mesh"), specs)
    with pytest.raises(ValueError, match="shardings for"):
        checkpoint.restore(str(run["root"] / "mesh"), specs,
                           shardings={"params": None})

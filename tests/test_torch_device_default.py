"""The port's entry points run on the card unless the caller names the
CPU: no ``device`` parameter defaults to ``"cpu"``, and ``None`` resolves
to the card without looking whether one is there."""

import inspect

import numpy as np
import pytest
import torch

import deltapq_tpu_torch
from deltapq_tpu_torch import (bench_gist, bigscale, cli, convert, entry,
                               index, synth)
from deltapq_tpu_torch.eval import groundtruth
from deltapq_tpu_torch.legacy import prefix_tree
from deltapq_tpu_torch.ops import (adc, adc_kernels, decoded, delta, fused,
                                   kmeans)
from deltapq_tpu_torch.parallel import (dryrun, fused_sharded, mesh,
                                        pipeline, runtime, sharded,
                                        sharded_tree)
from deltapq_tpu_torch.tree import build_device, serialize

ENTRY_POINTS = [
    index.DeltaPQIndex.__init__, index.DeltaPQIndex.build,
    index.DeltaPQIndex.load,
    fused.FusedDecodedEngine.__init__, fused.FusedCodesEngine.__init__,
    fused.FusedCompressedEngine.__init__,
    fused.FusedCompressedEngine.from_tiles,
    fused.FusedCompressedEngine.from_tree, fused.FusedCompressedEngine.load,
    fused.DedupCompressedEngine.__init__,
    bigscale.BigCompressedIndex.__init__,
    bigscale.ChunkedCompressedEngine.__init__,
    bigscale.ChunkedCompressedEngine.from_saved,
    adc.query_plain, kmeans.pq_learn,
    convert.engine_state_from_numpy, convert.load_jax_engine,
    convert.load_jax_index, convert.load_jax_decoded_engine,
    convert.tile_dict_state_from_numpy,
    synth.make_clustered_codes, synth.make_gist_workload, bench_gist.main,
    adc_kernels.TileDictEngine.__init__,
    decoded.DecodedEngine.__init__, decoded.DecodedEngine.load,
    groundtruth.exact_topk, groundtruth.groundtruth_from_file,
    cli.main, delta.query_compressed, delta.make_compressed_query_fn,
    adc.query_plain_tensors,
    mesh.make_mesh, runtime.init_distributed,
    fused_sharded.ShardedCompressedEngine.__init__,
    sharded.sharded_query_plain, sharded.sharded_query_decoded,
    pipeline.pipelined_query, sharded_tree.sharded_query_compressed,
    dryrun.dryrun_multichip,
    serialize.query_bits, serialize.query_row_store,
    prefix_tree.dichotomize_codewords, entry.entry,
    build_device.find_edges_by_diff_device,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS,
                         ids=lambda f: f.__qualname__)
def test_device_defaults_to_the_card(fn):
    p = inspect.signature(fn).parameters["device"]
    assert p.default is None, f"{fn.__qualname__}: device={p.default!r}"


def test_no_public_callable_defaults_to_the_cpu():
    """Every function and method of the package that takes ``device``."""
    import importlib
    import pathlib
    import pkgutil

    root = pathlib.Path(deltapq_tpu_torch.__file__).parent
    seen = 0
    for info in pkgutil.walk_packages([str(root)], "deltapq_tpu_torch."):
        mod = importlib.import_module(info.name)
        fns = []
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isclass(obj):
                fns += [f for f in vars(obj).values()
                        if inspect.isfunction(f)
                        or isinstance(f, (classmethod, staticmethod))]
            elif inspect.isfunction(obj):
                fns.append(obj)
        for f in fns:
            f = getattr(f, "__func__", f)
            p = inspect.signature(f).parameters.get("device")
            if p is not None and p.default is not inspect.Parameter.empty:
                seen += 1
                assert p.default is None, (mod.__name__, f.__qualname__)
    assert seen >= len(ENTRY_POINTS)


def test_none_is_the_card_and_is_not_probed():
    assert deltapq_tpu_torch.resolve_device() == torch.device("cuda")
    assert deltapq_tpu_torch.resolve_device(None).type == "cuda"
    assert deltapq_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert deltapq_tpu_torch.resolve_device(
        torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_default_device_raises_without_a_card():
    """On a host without a card nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default works")
    cw = np.zeros((2, 4, 2), np.float32)
    codes = np.zeros((8, 2), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        adc.query_plain(cw, np.zeros((1, 4), np.float32), codes, top_k=2)
    with pytest.raises((RuntimeError, AssertionError)):
        index.DeltaPQIndex(cw, codes, build_tree=False).search(
            np.zeros((1, 4), np.float32), 2)
    with pytest.raises((RuntimeError, AssertionError)):
        entry.entry()
    # the CLI, before any task (update reads files only)
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["-dataset", "unused", "-task", "update"])

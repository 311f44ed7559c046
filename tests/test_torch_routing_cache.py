"""The route-graph cache and the native route planner's boundary.

``maps.routing.graph_csr`` caches each town's CSR graph under ``id(town)``.
A ``TownMap`` that dies frees its address, and CPython may hand that
address to the next ``TownMap``: the entry must go with its town, or the
next town is planned over another town's graph (the native planner then
indexes past its arrays).  These tests

  (a) force that reuse, from Town02's arrays to Town04's, and hold
      ``graph_csr`` and the planned routes against a CSR built here;
  (b) check that a dead town leaves no entry behind;
  (c) feed ``plan_route_batch`` and ``plan_routes_native`` a graph that is
      not the town's, out-of-range waypoints and malformed CSRs, each of
      which must raise ``ValueError``;
  (d) build ``native/route_planner.cc`` with AddressSanitizer into a small
      standalone program and run it over Town01-Town04 with the CARNOVEL
      and CoRL2017 task queries (and once over a stale graph, which it
      must refuse), against the ctypes library;
  (e) hold the port's ``plan_route_batch`` against the JAX package's on
      the 27 CARNOVEL tasks at the evaluator's route capacity.
"""

import dataclasses
import gc
import os
import shutil
import subprocess

import numpy as np
import pytest

from oatomobile_torch import native
from oatomobile_torch.benchmarks.batched_eval import ROUTE_CAPACITY
from oatomobile_torch.benchmarks.carnovel.benchmark import (
    _TASKS as CARNOVEL_TASKS)
from oatomobile_torch.benchmarks.corl2017.benchmark import (
    _TASKS as CORL2017_TASKS)
from oatomobile_torch.maps import graph_csr, load_town, plan_route_batch
from oatomobile_torch.maps import routing
from oatomobile_torch.maps.assets import TownMap
from oatomobile_tpu.maps import load_town as jax_load_town
from oatomobile_tpu.maps import plan_route_batch as jax_plan_route_batch

# Tries to land a new TownMap on a freed one's address (CPython's small
# object allocator hands the freed block back at once: the first try).
REUSE_TRIES = 50

# A standalone program around route_planner.cc: reads one graph and its queries
# from a binary file (int32 fields: num_nodes, num_indices, num_queries,
# capacity, then indptr, indices, origins, dests), plans, and writes the
# return code, the lengths and the routes to another file.
_ASAN_MAIN = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" int32_t plan_routes(const int32_t*, const int32_t*, int32_t,
                               int32_t, const int32_t*, const int32_t*,
                               int32_t, int32_t, int32_t*, int32_t*);

static bool read(FILE* f, int32_t* dst, size_t n) {
  return fread(dst, sizeof(int32_t), n, f) == n;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* in = fopen(argv[1], "rb");
  if (in == nullptr) return 2;
  int32_t head[4];
  if (!read(in, head, 4)) return 2;
  const int32_t nodes = head[0], edges = head[1], queries = head[2],
                capacity = head[3];
  // Exact sizes: AddressSanitizer sees any access past them.
  std::vector<int32_t> indptr(nodes + 1), indices(edges), origins(queries),
      dests(queries), routes(static_cast<size_t>(queries) * capacity),
      lengths(queries);
  if (!read(in, indptr.data(), indptr.size()) ||
      !read(in, indices.data(), indices.size()) ||
      !read(in, origins.data(), origins.size()) ||
      !read(in, dests.data(), dests.size())) {
    return 2;
  }
  fclose(in);
  const int32_t code = plan_routes(indptr.data(), indices.data(), nodes,
                                   edges, origins.data(), dests.data(),
                                   queries, capacity, routes.data(),
                                   lengths.data());
  FILE* out = fopen(argv[2], "wb");
  if (out == nullptr) return 2;
  fwrite(&code, sizeof(int32_t), 1, out);
  fwrite(lengths.data(), sizeof(int32_t), lengths.size(), out);
  fwrite(routes.data(), sizeof(int32_t), routes.size(), out);
  fclose(out);
  return 0;
}
"""


def _arrays(name: str) -> dict:
  town = load_town(name)
  return {f.name: getattr(town, f.name) for f in dataclasses.fields(town)}


def _fresh_csr(town) -> tuple:
  """The town's successor graph as CSR, built here and never cached."""
  counts = town.wp_num_next.astype(np.int64)
  indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
  live = np.arange(town.wp_next.shape[1])[None, :] < counts[:, None]
  return indptr, town.wp_next[live].astype(np.int32)


def _task_queries(town, tasks) -> tuple:
  """(origin, destination) waypoints of the tasks set in ``town``."""
  configs = [c for _, c in sorted(tasks.items()) if c["town"] == town.name]
  S = town.num_spawn_points
  return tuple(
      town.spawn_wp[np.asarray([c[key] for c in configs], np.int64) % S]
      for key in ("origin", "destination"))


@pytest.fixture(scope="module")
def library():
  if shutil.which("g++") is None:
    pytest.skip("needs g++ to build native/route_planner.cc")
  lib = native.get_library()
  assert lib is not None
  return lib


def test_forced_address_reuse_gives_the_new_towns_graph(library):
  del library
  town02, town04 = _arrays("Town02"), _arrays("Town04")
  for _ in range(REUSE_TRIES):
    old = TownMap(**town02)
    assert len(graph_csr(old)[0]) - 1 == 1884
    address = id(old)
    del old
    town = TownMap(**town04)
    if id(town) == address:
      break
  else:
    pytest.fail("no TownMap landed on a freed one's address in {} tries"
                .format(REUSE_TRIES))
  indptr, indices = graph_csr(town)
  want_indptr, want_indices = _fresh_csr(town)
  assert len(indptr) - 1 == town.num_waypoints == 9352
  np.testing.assert_array_equal(indptr, want_indptr)
  np.testing.assert_array_equal(indices, want_indices)
  origins, dests = _task_queries(town, CARNOVEL_TASKS)
  assert len(origins) == 8
  got = plan_route_batch(town, origins, dests, ROUTE_CAPACITY)
  want = native.plan_routes_native(want_indptr, want_indices, origins, dests,
                                   ROUTE_CAPACITY)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)


def test_dead_town_leaves_no_cache_entry():
  arrays = _arrays("Town02")
  before = len(routing._CSR_CACHE)
  town = TownMap(**arrays)
  graph_csr(town)
  key = id(town)
  assert key in routing._CSR_CACHE
  del town
  gc.collect()
  assert key not in routing._CSR_CACHE
  for _ in range(8):
    graph_csr(TownMap(**arrays))
  gc.collect()
  assert len(routing._CSR_CACHE) == before


def _stale_entry(town, other: str) -> None:
  """Puts ``other``'s graph in ``town``'s cache entry."""
  graph_csr(town)
  routing._CSR_CACHE[id(town)] = _fresh_csr(load_town(other))


@pytest.mark.parametrize("case", [
    "origin_past_end", "origin_negative", "destination_past_end",
    "stale_smaller_graph", "stale_larger_graph"])
def test_plan_route_batch_refuses_bad_inputs(case, library):
  del library
  town = TownMap(**_arrays("Town03"))
  W = town.num_waypoints
  origins = town.spawn_wp[:4].copy()
  dests = town.spawn_wp[4:8].copy()
  if case == "origin_past_end":
    origins[1] = W
  elif case == "origin_negative":
    origins[2] = -1
  elif case == "destination_past_end":
    dests[0] = W + 10
  elif case == "stale_smaller_graph":
    _stale_entry(town, "Town02")
  else:
    _stale_entry(town, "Town04")
  with pytest.raises(ValueError):
    plan_route_batch(town, origins, dests, ROUTE_CAPACITY)


@pytest.mark.parametrize("case", [
    "town04_queries_on_town02_graph", "origin_past_end", "origin_negative",
    "destination_past_end", "indptr_not_monotone", "indptr_end_not_edges",
    "index_past_end", "zero_capacity", "unequal_query_shapes"])
def test_plan_routes_native_refuses_bad_inputs(case, library):
  del library
  town02 = load_town("Town02")
  indptr, indices = _fresh_csr(town02)
  indptr, indices = indptr.copy(), indices.copy()
  origins, dests = _task_queries(town02, CORL2017_TASKS)
  origins, dests = origins[:8].copy(), dests[:8].copy()
  capacity = ROUTE_CAPACITY
  W = town02.num_waypoints
  if case == "town04_queries_on_town02_graph":
    origins, dests = _task_queries(load_town("Town04"), CARNOVEL_TASKS)
    assert max(origins.max(), dests.max()) >= W
  elif case == "origin_past_end":
    origins[3] = W
  elif case == "origin_negative":
    origins[0] = -5
  elif case == "destination_past_end":
    dests[7] = W
  elif case == "indptr_not_monotone":
    indptr[10] = indptr[12] + 1
  elif case == "indptr_end_not_edges":
    indices = indices[:-1]
  elif case == "index_past_end":
    indices[100] = W
  elif case == "zero_capacity":
    capacity = 0
  else:
    dests = dests[:5]
  with pytest.raises(ValueError):
    native.plan_routes_native(indptr, indices, origins, dests, capacity)


@pytest.fixture(scope="module")
def asan_planner(tmp_path_factory, library):
  """route_planner.cc and the program above, built with AddressSanitizer."""
  del library
  out = tmp_path_factory.mktemp("asan")
  src = out / "main.cc"
  src.write_text(_ASAN_MAIN)
  binary = out / "plan_routes"
  planner = os.path.join(os.path.dirname(native.__file__),
                         "route_planner.cc")
  subprocess.run(["g++", "-O1", "-g", "-fsanitize=address",
                  "-fno-omit-frame-pointer", "-o", str(binary), str(src),
                  planner], check=True, capture_output=True, timeout=120)
  return binary


def _run_asan(binary, tmp_path, indptr, indices, origins, dests, capacity):
  """(code, lengths, routes) from the AddressSanitizer build; fails on
  any report (the program exits non-zero on one)."""
  inp, outp = tmp_path / "in.bin", tmp_path / "out.bin"
  head = np.asarray([len(indptr) - 1, len(indices), len(origins), capacity])
  np.concatenate([head, indptr, indices, origins, dests]).astype(
      np.int32).tofile(inp)
  env = dict(os.environ, ASAN_OPTIONS="halt_on_error=1:detect_leaks=1")
  run = subprocess.run([str(binary), str(inp), str(outp)], env=env,
                       capture_output=True, text=True, timeout=120)
  assert run.returncode == 0, run.stderr[-4000:]
  assert "AddressSanitizer" not in run.stderr, run.stderr[-4000:]
  out = np.fromfile(outp, dtype=np.int32)
  Q = len(origins)
  return (int(out[0]), out[1:1 + Q],
          out[1 + Q:].reshape(Q, capacity) if out[0] == 0 else None)


@pytest.mark.parametrize("name", ["Town01", "Town02", "Town03", "Town04"])
def test_route_planner_under_address_sanitizer(name, asan_planner, tmp_path):
  town = load_town(name)
  indptr, indices = _fresh_csr(town)
  origins, dests = [np.concatenate(q) for q in zip(
      _task_queries(town, CARNOVEL_TASKS),
      _task_queries(town, CORL2017_TASKS))]
  assert len(origins) > 0
  code, lengths, routes = _run_asan(asan_planner, tmp_path, indptr, indices,
                                    origins, dests, ROUTE_CAPACITY)
  assert code == 0
  want_routes, want_lengths = native.plan_routes_native(
      indptr, indices, origins, dests, ROUTE_CAPACITY)
  np.testing.assert_array_equal(lengths, want_lengths)
  np.testing.assert_array_equal(routes, want_routes)
  assert (lengths > 1).all()


def test_route_planner_refuses_a_stale_graph_under_address_sanitizer(
    asan_planner, tmp_path):
  # Town04's queries over Town02's graph: what a stale cache entry gave.
  indptr, indices = _fresh_csr(load_town("Town02"))
  origins, dests = _task_queries(load_town("Town04"), CARNOVEL_TASKS)
  code, _, _ = _run_asan(asan_planner, tmp_path, indptr, indices, origins,
                         dests, ROUTE_CAPACITY)
  assert code == 4  # kBadQuery


@pytest.mark.parametrize("name", ["Town03", "Town04"])
def test_carnovel_routes_equal_the_jax_package(name):
  jt, tt = jax_load_town(name), load_town(name)
  origins, dests = _task_queries(tt, CARNOVEL_TASKS)
  np.testing.assert_array_equal(
      np.asarray(_task_queries(jt, CARNOVEL_TASKS)), (origins, dests))
  assert len(origins) == {"Town03": 19, "Town04": 8}[name]
  want = jax_plan_route_batch(jt, origins, dests, ROUTE_CAPACITY)
  got = plan_route_batch(tt, origins, dests, ROUTE_CAPACITY)
  for a, b in zip(want, got):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)

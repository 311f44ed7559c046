// Batched BFS route planner over the lane-waypoint graph.
//
// Host-side native runtime component: replaces the per-episode Python BFS
// (oatomobile_torch/maps/routing.py) for large scene batches — the reference
// delegated all routing to CARLA's C++/Python A* (GlobalRoutePlanner,
// upstream oatomobile/utils/carla.py:703-744), re-run every 5 steps
// per vehicle; here the whole batch of episode routes is planned in one
// native call at reset time.
//
// Graph format: CSR over W nodes (indptr[W+1], indices[E]); edges are
// ~uniform length so BFS hop count ~ metric shortest path.
//
// Build: g++ -O3 -shared -fPIC -o libroute_planner.so route_planner.cc

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Return codes of plan_routes.
enum {
  kOk = 0,
  kBadCapacity = 1,  // capacity < 1
  kBadGraph = 2,     // indptr not monotone from 0 to num_indices
  kBadIndex = 3,     // a successor outside [0, num_nodes)
  kBadQuery = 4,     // an origin or destination outside [0, num_nodes)
};

// Plans `num_queries` routes.  For query q: BFS from origins[q] to
// dests[q]; writes up to `capacity` waypoint ids into
// routes_out[q*capacity ...], padding the tail with the final reached
// waypoint (saturating semantics expected by the device-side follower),
// and the true length into lengths_out[q].  Unreachable destinations
// produce a length-1 route at the origin.
//
// The graph and the queries are checked before any route is planned: on
// a bad input it returns one of the codes above and writes nothing, so a
// graph that is not the queries' town never indexes past its arrays.
int32_t plan_routes(const int32_t* indptr, const int32_t* indices,
                    int32_t num_nodes, int32_t num_indices,
                    const int32_t* origins, const int32_t* dests,
                    int32_t num_queries, int32_t capacity,
                    int32_t* routes_out, int32_t* lengths_out) {
  if (capacity < 1) return kBadCapacity;
  if (num_nodes < 0 || num_indices < 0 || indptr[0] != 0 ||
      indptr[num_nodes] != num_indices) {
    return kBadGraph;
  }
  for (int32_t u = 0; u < num_nodes; ++u) {
    if (indptr[u + 1] < indptr[u]) return kBadGraph;
  }
  for (int32_t e = 0; e < num_indices; ++e) {
    if (indices[e] < 0 || indices[e] >= num_nodes) return kBadIndex;
  }
  for (int32_t q = 0; q < num_queries; ++q) {
    if (origins[q] < 0 || origins[q] >= num_nodes || dests[q] < 0 ||
        dests[q] >= num_nodes) {
      return kBadQuery;
    }
  }

  std::vector<int32_t> parent(num_nodes);
  std::vector<int32_t> stamp(num_nodes, -1);
  std::vector<int32_t> queue(num_nodes);
  std::vector<int32_t> path;
  path.reserve(capacity);

  for (int32_t q = 0; q < num_queries; ++q) {
    const int32_t origin = origins[q];
    const int32_t dest = dests[q];
    int32_t* route = routes_out + static_cast<int64_t>(q) * capacity;
    path.clear();

    if (origin == dest) {
      path.push_back(origin);
    } else {
      // BFS with per-query stamps (no O(W) clearing per query).
      int32_t head = 0, tail = 0;
      queue[tail++] = origin;
      stamp[origin] = q;
      parent[origin] = origin;
      bool found = false;
      while (head < tail && !found) {
        const int32_t u = queue[head++];
        for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
          const int32_t v = indices[e];
          if (stamp[v] == q) continue;
          stamp[v] = q;
          parent[v] = u;
          if (v == dest) {
            found = true;
            break;
          }
          queue[tail++] = v;
        }
      }
      if (found) {
        // Reconstruct (reversed), then flip.
        int32_t v = dest;
        while (v != origin) {
          path.push_back(v);
          v = parent[v];
        }
        path.push_back(origin);
        for (size_t i = 0, j = path.size() - 1; i < j; ++i, --j) {
          const int32_t tmp = path[i];
          path[i] = path[j];
          path[j] = tmp;
        }
      } else {
        path.push_back(origin);
      }
    }

    int32_t length = static_cast<int32_t>(path.size());
    if (length > capacity) length = capacity;
    lengths_out[q] = length;
    std::memcpy(route, path.data(), sizeof(int32_t) * length);
    const int32_t pad = route[length - 1];
    for (int32_t i = length; i < capacity; ++i) route[i] = pad;
  }
  return kOk;
}

}  // extern "C"

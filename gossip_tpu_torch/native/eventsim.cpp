// Native discrete-event core for the go-native parity backend.
//
// Mirrors gossip_tpu_torch/runtime/gonative.py event-for-event (that
// module's docstring is the semantics contract; both implement reference
// main.go:65-158 behavior — ack-before-process, dedup, sender exclusion,
// sequential blocking fan-out, the per-neighbor 2s-context retry loop with
// the reference's ctx-expiry liveness defect toggleable).  The Python
// implementation stays as the readable twin, run only when a caller asks
// for it (it is no fallback: without a compiler the build raises); this
// core exists because parity sweeps at N=1024+ with many messages are
// event-throughput-bound in Python (~1e5 events/s) while this runs ~1e7/s.
//
// Equivalence is enforced by tests/test_torch_gonative.py: identical deliveries,
// message counts, hop depths, and logs on shared scenarios, including
// partition windows and both ctx-bug modes.
//
// Exposed as a C API for ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Event {
  double t;
  uint64_t seq;
  // kind 0: deliver(dst, src, msg, hop)
  // kind 1: fanout(src, msg, hop, tgt_list_id, idx, attempt, ctx_start)
  int kind;
  int32_t a, b;     // deliver: dst, src       | fanout: src, tgt_list_id
  int64_t msg;
  int32_t hop;
  int32_t idx, attempt;
  double ctx_start;
};

struct EventCmp {
  bool operator()(const Event& x, const Event& y) const {
    if (x.t != y.t) return x.t > y.t;   // min-heap by (t, seq)
    return x.seq > y.seq;
  }
};

struct Delivery {
  double t;
  int32_t node;
  int64_t msg;
  int32_t hop;
};

struct Partition {
  int32_t a, b;
  double t0, t1;
};

struct Sim {
  // config (defaults match gonative.NetConfig)
  double latency = 0.001;
  double rpc_timeout = 2.0;
  double backoff_base = 0.1;
  bool faithful_ctx_bug = true;
  int max_backoff_doublings = 40;
  double horizon = 120.0;

  int n = 0;
  std::vector<std::vector<int32_t>> neighbors;
  std::vector<std::vector<int64_t>> log;
  std::vector<std::unordered_set<int64_t>> seen;
  std::vector<Partition> partitions;
  std::priority_queue<Event, std::vector<Event>, EventCmp> q;
  uint64_t seq = 0;
  int64_t msgs_sent = 0;
  double now = 0.0;
  std::vector<Delivery> deliveries;
  // (node, msg) -> min hop over all arrivals (dedup'd arrivals included)
  std::unordered_map<int64_t, std::unordered_map<int64_t, int32_t>> min_hop;
  // fan-out target lists are interned so events stay POD
  std::vector<std::vector<int32_t>> tgt_lists;

  bool link_open(int32_t a, int32_t b, double t) const {
    for (const auto& p : partitions) {
      if (((p.a == a && p.b == b) || (p.a == b && p.b == a)) &&
          p.t0 <= t && t < p.t1)
        return false;
    }
    return true;
  }

  void push(double t, Event e) {
    // mirror gonative._push_event: never drop — run() bounds the clock
    e.t = t;
    e.seq = seq++;
    q.push(e);
  }

  void deliver(double t, int32_t dst, int32_t src, int64_t msg, int32_t hop) {
    msgs_sent += 2;   // the broadcast request + the ack sent FIRST
    auto& mh = min_hop[dst];
    auto it = mh.find(msg);
    if (it == mh.end() || hop < it->second) mh[msg] = hop;
    auto& s = seen[dst];
    if (s.count(msg)) return;                    // dedup (main.go:113)
    s.insert(msg);
    log[dst].push_back(msg);                     // append (main.go:117)
    deliveries.push_back({t, dst, msg, hop});
    // fan-out, excluding the sender (main.go:72-75)
    std::vector<int32_t> targets;
    for (int32_t nb : neighbors[dst])
      if (nb != src) targets.push_back(nb);
    if (!targets.empty()) {
      tgt_lists.push_back(std::move(targets));
      Event e{};
      e.kind = 1;
      e.a = dst;
      e.b = static_cast<int32_t>(tgt_lists.size() - 1);
      e.msg = msg;
      e.hop = hop;
      e.idx = 0;
      e.attempt = 0;
      e.ctx_start = t;
      push(t, e);
    }
  }

  void fanout(double t, int32_t src, int32_t list_id, int64_t msg,
              int32_t hop, int32_t idx, int32_t attempt, double ctx_start) {
    const auto& targets = tgt_lists[list_id];
    if (idx >= static_cast<int32_t>(targets.size())) return;
    int32_t nb = targets[idx];
    double deadline = ctx_start + rpc_timeout;
    if (link_open(src, nb, t)) {
      Event d{};
      d.kind = 0;
      d.a = nb;
      d.b = src;
      d.msg = msg;
      d.hop = hop + 1;
      push(t + latency, d);
      if (t + 2 * latency <= deadline) {
        Event nxt{};
        nxt.kind = 1;
        nxt.a = src;
        nxt.b = list_id;
        nxt.msg = msg;
        nxt.hop = hop;
        nxt.idx = idx + 1;
        nxt.attempt = 0;
        nxt.ctx_start = t + 2 * latency;
        push(t + 2 * latency, nxt);
        return;
      }
    }
    double fail_at = t < deadline ? deadline : t;
    int k = attempt < max_backoff_doublings ? attempt : max_backoff_doublings;
    double retry_at = fail_at + backoff_base * std::pow(2.0, k);
    Event r{};
    r.kind = 1;
    r.a = src;
    r.b = list_id;
    r.msg = msg;
    r.hop = hop;
    r.idx = idx;
    r.attempt = attempt + 1;
    r.ctx_start = faithful_ctx_bug ? ctx_start : retry_at;
    push(retry_at, r);
  }

  void run(double until) {
    while (!q.empty() && q.top().t <= until) {
      Event e = q.top();
      q.pop();
      now = e.t;
      if (e.kind == 0)
        deliver(e.t, e.a, e.b, e.msg, e.hop);
      else
        fanout(e.t, e.a, e.b, e.msg, e.hop, e.idx, e.attempt, e.ctx_start);
    }
  }
};

}  // namespace

extern "C" {

void* gsim_create(int32_t n) {
  Sim* s = new Sim();
  s->n = n;
  s->neighbors.resize(n);
  s->log.resize(n);
  s->seen.resize(n);
  return s;
}

void gsim_destroy(void* p) { delete static_cast<Sim*>(p); }

void gsim_config(void* p, double latency, double rpc_timeout,
                 double backoff_base, int32_t faithful,
                 int32_t max_doublings, double horizon) {
  Sim* s = static_cast<Sim*>(p);
  s->latency = latency;
  s->rpc_timeout = rpc_timeout;
  s->backoff_base = backoff_base;
  s->faithful_ctx_bug = faithful != 0;
  s->max_backoff_doublings = max_doublings;
  s->horizon = horizon;
}

void gsim_set_neighbors(void* p, int32_t node, const int32_t* nbrs,
                        int32_t count) {
  Sim* s = static_cast<Sim*>(p);
  s->neighbors[node].assign(nbrs, nbrs + count);
}

void gsim_partition(void* p, int32_t a, int32_t b, double t0, double t1) {
  static_cast<Sim*>(p)->partitions.push_back({a, b, t0, t1});
}

void gsim_broadcast(void* p, int32_t origin, int64_t msg, double t) {
  Sim* s = static_cast<Sim*>(p);
  Event e{};
  e.kind = 0;
  e.a = origin;
  e.b = -1;                     // client src: excluded from nothing
  e.msg = msg;
  e.hop = 0;
  s->push(t, e);
}

void gsim_run(void* p, double until) {
  Sim* s = static_cast<Sim*>(p);
  s->run(until < 0 ? s->horizon : until);
}

int64_t gsim_msgs_sent(void* p) { return static_cast<Sim*>(p)->msgs_sent; }
double gsim_now(void* p) { return static_cast<Sim*>(p)->now; }

int32_t gsim_read_len(void* p, int32_t node) {
  return static_cast<int32_t>(static_cast<Sim*>(p)->log[node].size());
}

void gsim_read(void* p, int32_t node, int64_t* out) {
  const auto& l = static_cast<Sim*>(p)->log[node];
  std::memcpy(out, l.data(), l.size() * sizeof(int64_t));
}

int32_t gsim_min_hop(void* p, int32_t node, int64_t msg) {
  Sim* s = static_cast<Sim*>(p);
  auto nit = s->min_hop.find(node);
  if (nit == s->min_hop.end()) return -1;
  auto mit = nit->second.find(msg);
  return mit == nit->second.end() ? -1 : mit->second;
}

int32_t gsim_delivery_count(void* p) {
  return static_cast<int32_t>(static_cast<Sim*>(p)->deliveries.size());
}

void gsim_deliveries(void* p, double* times, int32_t* nodes, int64_t* msgs,
                     int32_t* hops) {
  const auto& d = static_cast<Sim*>(p)->deliveries;
  for (size_t i = 0; i < d.size(); ++i) {
    times[i] = d[i].t;
    nodes[i] = d[i].node;
    msgs[i] = d[i].msg;
    hops[i] = d[i].hop;
  }
}

}  // extern "C"

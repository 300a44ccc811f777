// Native mini-Maelstrom router: the L-1 harness as a standalone C++ binary.
//
// The reference was tested by the external Maelstrom harness — a process
// orchestrator that spawns N copies of the node binary, routes newline-
// delimited JSON envelopes between their stdin/stdout pipes, injects
// latency and partitions, and checks the broadcast workload's invariant
// (SURVEY.md §1 L-1, §4).  The Python twin lives in
// runtime/maelstrom_harness.py; this file is the NATIVE twin: same
// envelope protocol, same workload, same checker semantics, one poll()
// event loop, zero dependencies.  Build + drive via
// runtime/native_router.py; equivalence against the Python harness is
// tested in tests/test_torch_maelstrom.py.
//
// Usage:
//   router --n 5 --latency-ms 2 --ops 20 --rate 50 --topology line \
//          [--partition] [--seed 0] -- python -m gossip_tpu_torch.runtime.maelstrom_node
//
// Prints one JSON stats line (msgs routed, per-op latencies, invariant)
// and exits 0 iff every broadcast value eventually appears in every
// node's read (the Maelstrom checker's invariant).

#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <poll.h>
#include <signal.h>
#include <sys/wait.h>
#include <unistd.h>

#include <algorithm>
#include <map>
#include <memory>
#include <queue>
#include <set>
#include <string>
#include <vector>

// ---------------------------------------------------------------- util --
static double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

[[noreturn]] static void die(const std::string& msg) {
  fprintf(stderr, "router: %s\n", msg.c_str());
  exit(2);
}

// ------------------------------------------------- minimal JSON reader --
// Machine-generated JSON only (the nodes emit json.dumps output).  Parses
// the full value tree; numbers as double (msg ids / payloads fit).
struct JV {
  enum T { NUL, BOO, NUM, STR, ARR, OBJ } t = NUL;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<JV> arr;
  std::map<std::string, JV> obj;

  const JV* get(const std::string& k) const {
    if (t != OBJ) return nullptr;
    auto it = obj.find(k);
    return it == obj.end() ? nullptr : &it->second;
  }
};

struct JParser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit JParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++; }
  bool lit(const char* s) {
    size_t l = strlen(s);
    if ((size_t)(end - p) >= l && !strncmp(p, s, l)) { p += l; return true; }
    return false;
  }

  JV parse() { ws(); JV v = value(); ws(); if (p != end) ok = false; return v; }

  JV value() {
    ws();
    if (p >= end) { ok = false; return {}; }
    switch (*p) {
      case '{': return object();
      case '[': return array();
      case '"': { JV v; v.t = JV::STR; v.str = string(); return v; }
      case 't': { JV v; v.t = JV::BOO; v.b = true; if (!lit("true")) ok = false; return v; }
      case 'f': { JV v; v.t = JV::BOO; v.b = false; if (!lit("false")) ok = false; return v; }
      case 'n': { JV v; if (!lit("null")) ok = false; return v; }
      default: return number();
    }
  }

  std::string string() {
    std::string out;
    p++;                                   // opening quote
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        p++;
        switch (*p) {
          case 'n': out += '\n'; break;
          case 't': out += '\t'; break;
          case 'r': out += '\r'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'u': {                       // \uXXXX: raw byte for BMP ASCII
            if (end - p >= 5) {
              unsigned code = strtoul(std::string(p + 1, p + 5).c_str(), nullptr, 16);
              if (code < 0x80) out += (char)code; else out += '?';
              p += 4;
            } else ok = false;
            break;
          }
          default: out += *p;
        }
      } else out += *p;
      p++;
    }
    if (p < end) p++; else ok = false;      // closing quote
    return out;
  }

  JV number() {
    char* e = nullptr;
    JV v; v.t = JV::NUM;
    v.num = strtod(p, &e);
    if (e == p) { ok = false; return v; }
    p = e;
    return v;
  }

  JV array() {
    JV v; v.t = JV::ARR;
    p++; ws();
    if (p < end && *p == ']') { p++; return v; }
    while (p < end) {
      v.arr.push_back(value()); ws();
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == ']') { p++; return v; }
      break;
    }
    ok = false; return v;
  }

  JV object() {
    JV v; v.t = JV::OBJ;
    p++; ws();
    if (p < end && *p == '}') { p++; return v; }
    while (p < end) {
      ws();
      if (p >= end || *p != '"') break;
      std::string k = string(); ws();
      if (p >= end || *p != ':') break;
      p++;
      v.obj[k] = value(); ws();
      if (p < end && *p == ',') { p++; continue; }
      if (p < end && *p == '}') { p++; return v; }
      break;
    }
    ok = false; return v;
  }
};

// ------------------------------------------------------------ children --
struct Node {
  std::string id;
  pid_t pid = -1;
  int to_fd = -1;      // our write end -> node stdin (nonblocking)
  int from_fd = -1;    // our read end  <- node stdout (nonblocking)
  std::string buf;     // partial-line read buffer
  std::string outq;    // pending bytes for the node's stdin — writes are
                       // nonblocking + queued so a node stalled on its
                       // own full stdout can never deadlock the router
};

static void try_flush(Node& nd) {
  while (!nd.outq.empty()) {
    ssize_t w = write(nd.to_fd, nd.outq.data(), nd.outq.size());
    if (w > 0) { nd.outq.erase(0, (size_t)w); continue; }
    if (w < 0 && errno == EINTR) continue;
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
    nd.outq.clear();                       // dead node: drop its queue
    return;
  }
}

static void enqueue(Node& nd, const std::string& s) {
  nd.outq += s;
  try_flush(nd);
}

// ------------------------------------------------------------- router --
struct Delivery {
  double at;
  int dest;
  std::string line;
  bool operator>(const Delivery& o) const { return at > o.at; }
};

struct Router {
  std::vector<Node> nodes;
  std::map<std::string, int> by_id;
  double latency = 0.002;
  long routed = 0;
  double last_activity = 0;
  // one partition window (a, b, t0, t1), both directions
  int part_a = -1, part_b = -1;
  double part_t0 = 0, part_t1 = 0;
  std::priority_queue<Delivery, std::vector<Delivery>, std::greater<Delivery>> delayed;
  long next_msg_id = 1000;
  // pending client RPC: msg_id -> reply (filled by pump)
  std::map<long, JV> replies;

  bool link_open(int a, int b, double t) const {
    if (part_a < 0) return true;
    bool cut = ((a == part_a && b == part_b) || (a == part_b && b == part_a));
    return !(cut && t >= part_t0 && t < part_t1);
  }

  void flush_delayed(double t) {
    while (!delayed.empty() && delayed.top().at <= t) {
      const Delivery& d = delayed.top();
      enqueue(nodes[d.dest], d.line);
      delayed.pop();
    }
  }

  // Read whatever is available on node stdouts, drain pending stdin
  // queues; route node->node traffic, stash client replies.  Returns
  // after at most max_wait_s.
  void pump(double max_wait_s) {
    double t = now_s();
    flush_delayed(t);
    double wait = max_wait_s;
    if (!delayed.empty())
      wait = std::min(wait, std::max(0.0, delayed.top().at - t));
    std::vector<pollfd> fds(nodes.size());
    for (size_t i = 0; i < nodes.size(); i++) {
      fds[i] = {nodes[i].from_fd, POLLIN, 0};
      if (!nodes[i].outq.empty())
        fds.push_back({nodes[i].to_fd, POLLOUT, 0});
    }
    int rc = poll(fds.data(), fds.size(), (int)(wait * 1000));
    if (rc <= 0) { flush_delayed(now_s()); return; }
    // writable stdin queues first: frees nodes blocked on their input
    for (size_t k = nodes.size(); k < fds.size(); k++)
      if (fds[k].revents & (POLLOUT | POLLERR))
        for (auto& nd : nodes)
          if (nd.to_fd == fds[k].fd) { try_flush(nd); break; }
    char tmp[65536];
    for (size_t i = 0; i < nodes.size(); i++) {
      if (!(fds[i].revents & (POLLIN | POLLHUP))) continue;
      ssize_t r = read(nodes[i].from_fd, tmp, sizeof tmp);
      if (r <= 0) continue;
      nodes[i].buf.append(tmp, (size_t)r);
      size_t pos;
      while ((pos = nodes[i].buf.find('\n')) != std::string::npos) {
        std::string line = nodes[i].buf.substr(0, pos + 1);
        nodes[i].buf.erase(0, pos + 1);
        route(line);
      }
    }
    flush_delayed(now_s());
  }

  void route(const std::string& line) {
    JParser jp(line);
    JV msg = jp.parse();
    if (!jp.ok || msg.t != JV::OBJ) return;
    const JV* dest = msg.get("dest");
    if (!dest || dest->t != JV::STR) return;
    last_activity = now_s();
    if (dest->str == "c1") {
      const JV* body = msg.get("body");
      const JV* irt = body ? body->get("in_reply_to") : nullptr;
      if (irt && irt->t == JV::NUM) replies[(long)irt->num] = msg;
      return;
    }
    auto it = by_id.find(dest->str);
    if (it == by_id.end()) return;
    const JV* src = msg.get("src");
    int s = -1;
    if (src && src->t == JV::STR) {
      auto sit = by_id.find(src->str);
      if (sit != by_id.end()) s = sit->second;
    }
    double t = now_s();
    if (s >= 0 && !link_open(s, it->second, t)) return;   // dropped in cut
    routed++;
    delayed.push({t + latency, it->second, line});
  }

  // Blocking client RPC that pumps the loop until the reply arrives.
  JV rpc(int dest, const std::string& body_json, double timeout) {
    long mid = ++next_msg_id;
    char head[256];
    snprintf(head, sizeof head, "{\"src\": \"c1\", \"dest\": \"%s\", \"body\": ",
             nodes[dest].id.c_str());
    // splice msg_id into the body object (body_json ends with '}')
    std::string body = body_json.substr(0, body_json.size() - 1);
    if (body.back() != '{') body += ", ";
    body += "\"msg_id\": " + std::to_string(mid) + "}";
    enqueue(nodes[dest], std::string(head) + body + "}\n");
    double deadline = now_s() + timeout;
    while (now_s() < deadline) {
      auto it = replies.find(mid);
      if (it != replies.end()) {
        JV r = it->second;
        replies.erase(it);
        return r;
      }
      pump(0.01);
    }
    return {};                                   // NUL on timeout
  }
};

// ------------------------------------------------------------ workload --
int main(int argc, char** argv) {
  int n = 5, ops = 20, seed = 0;
  double latency_ms = 2.0, rate = 50.0;
  std::string topology = "line";
  bool partition = false;
  std::vector<char*> cmd;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&]() -> char* { if (i + 1 >= argc) die("missing value for " + a); return argv[++i]; };
    if (a == "--n") n = atoi(next());
    else if (a == "--latency-ms") latency_ms = atof(next());
    else if (a == "--ops") ops = atoi(next());
    else if (a == "--rate") rate = atof(next());
    else if (a == "--topology") topology = next();
    else if (a == "--partition") partition = true;
    else if (a == "--seed") seed = atoi(next());
    else if (a == "--") { for (int j = i + 1; j < argc; j++) cmd.push_back(argv[j]); break; }
    else die("unknown arg " + a);
  }
  if (cmd.empty()) die("node command required after --");
  if (n < 1 || ops < 1 || rate <= 0) die("bad workload parameters");
  cmd.push_back(nullptr);
  signal(SIGPIPE, SIG_IGN);

  Router rt;
  rt.latency = latency_ms / 1e3;
  for (int i = 0; i < n; i++) {
    Node nd;
    nd.id = "n" + std::to_string(i);
    int in_pipe[2], out_pipe[2];
    if (pipe(in_pipe) || pipe(out_pipe)) die("pipe failed");
    pid_t pid = fork();
    if (pid < 0) die("fork failed");
    if (pid == 0) {
      dup2(in_pipe[0], 0);
      dup2(out_pipe[1], 1);
      close(in_pipe[0]); close(in_pipe[1]);
      close(out_pipe[0]); close(out_pipe[1]);
      execvp(cmd[0], cmd.data());
      _exit(127);
    }
    close(in_pipe[0]); close(out_pipe[1]);
    fcntl(out_pipe[0], F_SETFL, O_NONBLOCK);
    fcntl(in_pipe[1], F_SETFL, O_NONBLOCK);
    // CLOEXEC: later-forked siblings must not inherit this node's
    // parent-side pipe ends.  The load-bearing one is in_pipe[1] (the
    // write end of this node's STDIN pipe): a sibling holding it would
    // keep the node from ever seeing EOF after the router closes to_fd.
    // (POLLHUP on a crashed node's stdout was never at risk — the
    // parent closes out_pipe[1] above, before any later fork.)
    fcntl(out_pipe[0], F_SETFD, FD_CLOEXEC);
    fcntl(in_pipe[1], F_SETFD, FD_CLOEXEC);
    nd.pid = pid;
    nd.to_fd = in_pipe[1];
    nd.from_fd = out_pipe[0];
    rt.by_id[nd.id] = i;
    rt.nodes.push_back(nd);
  }

  // init handshake
  std::string ids_json;
  for (int i = 0; i < n; i++)
    ids_json += (i ? ", " : "") + ("\"" + rt.nodes[i].id + "\"");
  for (int i = 0; i < n; i++) {
    JV r = rt.rpc(i, "{\"type\": \"init\", \"node_id\": \"" + rt.nodes[i].id +
                     "\", \"node_ids\": [" + ids_json + "]}", 15.0);
    const JV* b = r.get("body");
    const JV* ty = b ? b->get("type") : nullptr;
    if (!ty || ty->str != "init_ok") die("init failed for " + rt.nodes[i].id);
  }

  // topology (line or square-ish grid), sent to every node
  int cols = topology == "grid" ? std::max(1, (int)std::lround(std::sqrt((double)n))) : 1;
  std::vector<std::vector<int>> nbrs(n);
  for (int i = 0; i < n; i++) {
    if (topology == "grid") {
      int r = i / cols, c = i % cols;
      int cand[4][2] = {{r - 1, c}, {r + 1, c}, {r, c - 1}, {r, c + 1}};
      for (auto& rc : cand) {
        int j = rc[0] * cols + rc[1];
        if (rc[0] >= 0 && rc[1] >= 0 && rc[1] < cols && j >= 0 && j < n && rc[0] <= (n - 1) / cols)
          nbrs[i].push_back(j);
      }
    } else {
      if (i > 0) nbrs[i].push_back(i - 1);
      if (i < n - 1) nbrs[i].push_back(i + 1);
    }
  }
  std::string topo_json = "{";
  for (int i = 0; i < n; i++) {
    topo_json += (i ? ", " : "") + ("\"" + rt.nodes[i].id + "\": [");
    for (size_t k = 0; k < nbrs[i].size(); k++)
      topo_json += (k ? ", " : "") + ("\"" + rt.nodes[nbrs[i][k]].id + "\"");
    topo_json += "]";
  }
  topo_json += "}";
  for (int i = 0; i < n; i++) {
    JV r = rt.rpc(i, "{\"type\": \"topology\", \"topology\": " + topo_json + "}", 15.0);
    const JV* b = r.get("body");
    const JV* ty = b ? b->get("type") : nullptr;
    if (!ty || ty->str != "topology_ok") die("topology failed");
  }

  // optional mid-cluster cut over the middle third of the send window,
  // on a REAL edge (runtime/maelstrom_harness.py semantics)
  if (partition && n >= 2) {
    int a = n / 2;
    int b = nbrs[a].empty() ? a : nbrs[a][0];
    double span = ops / rate;
    rt.part_a = a; rt.part_b = b;
    rt.part_t0 = now_s() + span / 3;
    rt.part_t1 = rt.part_t0 + span / 3;
  }

  // broadcasts at the target rate to seeded-random nodes
  srand(seed);
  std::vector<double> op_lat;
  for (int v = 0; v < ops; v++) {
    int target = rand() % n;
    double t0 = now_s();
    rt.rpc(target, "{\"type\": \"broadcast\", \"message\": " + std::to_string(v) + "}", 15.0);
    op_lat.push_back(now_s() - t0);
    double until = t0 + 1.0 / rate;
    while (now_s() < until) rt.pump(until - now_s());
  }

  // quiesce: no traffic for 0.3 s (bounded), then EVENTUAL-delivery check
  double qdeadline = now_s() + 60.0;
  while (now_s() < qdeadline && now_s() - rt.last_activity < 0.3)
    rt.pump(0.1);
  bool invariant = false;
  double cdeadline = now_s() + 30.0;
  while (true) {
    invariant = true;
    for (int i = 0; i < n && invariant; i++) {
      JV r = rt.rpc(i, "{\"type\": \"read\"}", 15.0);
      const JV* b = r.get("body");
      const JV* msgs = b ? b->get("messages") : nullptr;
      std::set<long> have;
      if (msgs && msgs->t == JV::ARR)
        for (const JV& e : msgs->arr)
          if (e.t == JV::NUM) have.insert((long)e.num);
      for (int v = 0; v < ops; v++)
        if (!have.count(v)) { invariant = false; break; }
    }
    if (invariant || now_s() > cdeadline) break;
    double until = now_s() + 0.5;
    while (now_s() < until) rt.pump(until - now_s());
  }

  // stats (checker-style; matches maelstrom_harness.stats())
  std::sort(op_lat.begin(), op_lat.end());
  auto pct = [&](double p) {
    if (op_lat.empty()) return 0.0;
    size_t i = std::min(op_lat.size() - 1, (size_t)(p * op_lat.size()));
    return op_lat[i] * 1e3;
  };
  double mean = 0;
  for (double x : op_lat) mean += x;
  mean = op_lat.empty() ? 0 : mean * 1e3 / op_lat.size();
  printf("{\"engine\": \"native-router\", \"nodes\": %d, \"broadcast_ops\": %d, "
         "\"msgs_routed\": %ld, \"msgs_per_op\": %.3f, "
         "\"op_latency_ms\": {\"mean\": %.3f, \"p50\": %.3f, \"p99\": %.3f, \"max\": %.3f}, "
         "\"link_latency_ms\": %.3f, \"invariant_ok\": %s, \"values\": %d, "
         "\"partitioned\": %s}\n",
         n, ops, rt.routed, ops ? (double)rt.routed / ops : 0.0,
         mean, pct(0.50), pct(0.99),
         op_lat.empty() ? 0.0 : op_lat.back() * 1e3,
         latency_ms, invariant ? "true" : "false", ops,
         partition ? "true" : "false");
  fflush(stdout);

  for (auto& nd : rt.nodes) { kill(nd.pid, SIGKILL); }
  for (auto& nd : rt.nodes) { int st; waitpid(nd.pid, &st, 0); }
  return invariant ? 0 : 1;
}

// tb_runtime: native host runtime — event loop, TCP message bus, and
// the C-ABI client session.
//
// The port's copy of the reference package's native/tb_runtime.cpp, a
// re-design of the original's native runtime components (reference:
// src/io/linux.zig io_uring proactor, src/message_bus.zig TCP mesh,
// src/clients/c/tb_client.zig C ABI).  The compute path is the state
// machine's; this is the host side: non-blocking epoll
// event loop, header-framed message streams (a message is self-framing
// via the `size` u32 at byte offset 144 of the 256-byte header — see
// tigerbeetle_tpu_torch/vsr/wire.py HEADER_DTYPE), per-connection send
// queues, and a synchronous-API client with request/reply matching.
//
// Exposed as a C ABI for ctypes (Python) and any other language
// binding, mirroring the tb_client role.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

#include "sha256.h"

namespace {

constexpr uint32_t HEADER_SIZE = 256;
constexpr uint32_t SIZE_OFFSET = 144;  // wire.py HEADER_DTYPE "size"

// Header field offsets (must match tigerbeetle_tpu_torch/vsr/wire.py).
constexpr uint32_t OFF_CHECKSUM = 0;
constexpr uint32_t OFF_CHECKSUM_BODY = 16;
constexpr uint32_t OFF_CLIENT = 48;
constexpr uint32_t OFF_CLUSTER = 64;
constexpr uint32_t OFF_REQUEST = 112;
constexpr uint32_t OFF_COMMAND = 153;
constexpr uint32_t OFF_OPERATION = 154;
constexpr uint32_t OFF_VERSION = 155;

constexpr uint8_t CMD_REQUEST = 5;
constexpr uint8_t CMD_REPLY = 8;
constexpr uint8_t CMD_EVICTION = 18;
constexpr uint8_t OP_REGISTER = 2;
constexpr uint8_t WIRE_VERSION = 1;

void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
void put_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
uint32_t get_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }

int set_nonblocking(int fd) {
    int flags = fcntl(fd, F_GETFL, 0);
    return fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

struct Connection {
    int fd = -1;
    bool connecting = false;
    std::vector<uint8_t> recv_buf;
    std::deque<std::vector<uint8_t>> send_queue;
    size_t send_offset = 0;
};

}  // namespace

// ----------------------------------------------------------------------
// Bus.

extern "C" {

struct tb_event {
    int32_t type;  // 1=accepted 2=connected 3=message 4=closed
    int32_t conn;
    const uint8_t* data;  // message events: valid until next poll
    uint32_t len;
};

struct tb_bus {
    int epfd = -1;
    int listen_fd = -1;
    uint32_t message_size_max = 1u << 20;
    int next_conn = 1;
    std::map<int, Connection> conns;       // conn id -> state
    std::map<int, int> fd_to_conn;
    std::deque<tb_event> events;
    // Message buffers backing queued events' data pointers, FIFO in
    // event order.  A buffer must outlive BOTH its queued event and
    // (for the legacy next_event API) the poll that follows its
    // consumption — so consumed buffers are counted and reclaimed at
    // the next poll, NOT freed on pop (clearing only when the event
    // deque drained empty leaked every buffer under sustained load,
    // where the deque is never observed empty).
    std::deque<std::vector<uint8_t>> held;
    size_t held_consumed = 0;
};

tb_bus* tb_bus_create(uint32_t message_size_max) {
    tb_bus* bus = new tb_bus();
    bus->epfd = epoll_create1(0);
    if (message_size_max) bus->message_size_max = message_size_max;
    if (bus->epfd < 0) { delete bus; return nullptr; }
    return bus;
}

void tb_bus_destroy(tb_bus* bus) {
    if (!bus) return;
    for (auto& [id, c] : bus->conns) close(c.fd);
    if (bus->listen_fd >= 0) close(bus->listen_fd);
    if (bus->epfd >= 0) close(bus->epfd);
    delete bus;
}

static void bus_arm(tb_bus* bus, Connection& c) {
    epoll_event ev{};
    ev.events = EPOLLIN | (c.send_queue.empty() && !c.connecting
                               ? 0u
                               : uint32_t(EPOLLOUT));
    ev.data.fd = c.fd;
    epoll_ctl(bus->epfd, EPOLL_CTL_MOD, c.fd, &ev);
}

int tb_bus_listen(tb_bus* bus, const char* host, uint16_t port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        listen(fd, 64) < 0) {
        close(fd);
        return -1;
    }
    set_nonblocking(fd);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    epoll_ctl(bus->epfd, EPOLL_CTL_ADD, fd, &ev);
    bus->listen_fd = fd;
    return 0;
}

// Bound port of the listener (for port-0 listens).
int tb_bus_listen_port(tb_bus* bus) {
    if (bus->listen_fd < 0) return -1;
    sockaddr_in addr{};
    socklen_t len = sizeof(addr);
    getsockname(bus->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    return ntohs(addr.sin_port);
}

int tb_bus_connect(tb_bus* bus, const char* host, uint16_t port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    set_nonblocking(fd);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    inet_pton(AF_INET, host, &addr.sin_addr);
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) { close(fd); return -1; }
    int id = bus->next_conn++;
    Connection& c = bus->conns[id];
    c.fd = fd;
    c.connecting = (rc < 0);
    bus->fd_to_conn[fd] = id;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.fd = fd;
    epoll_ctl(bus->epfd, EPOLL_CTL_ADD, fd, &ev);
    if (rc == 0) bus->events.push_back({2, id, nullptr, 0});
    return id;
}

int tb_bus_send(tb_bus* bus, int conn, const uint8_t* data, uint32_t len) {
    auto it = bus->conns.find(conn);
    if (it == bus->conns.end()) return -1;
    Connection& c = it->second;
    c.send_queue.emplace_back(data, data + len);
    bus_arm(bus, c);
    return 0;
}

// Scatter-gather send: header + body queued as ONE message without
// the caller concatenating them first (the Python-side `header.tobytes
// () + body` concat copied every megabyte body an extra time per hop).
int tb_bus_send2(tb_bus* bus, int conn, const uint8_t* head,
                 uint32_t head_len, const uint8_t* body,
                 uint32_t body_len) {
    auto it = bus->conns.find(conn);
    if (it == bus->conns.end()) return -1;
    Connection& c = it->second;
    c.send_queue.emplace_back();
    auto& msg = c.send_queue.back();
    msg.reserve(size_t(head_len) + body_len);
    msg.insert(msg.end(), head, head + head_len);
    msg.insert(msg.end(), body, body + body_len);
    bus_arm(bus, c);
    return 0;
}

// Vector send (the drain loop): queue k complete frames for one
// connection in a single crossing — the backup's per-drain prepare_ok
// run and any other same-destination frame burst.  Each frame is
// appended as its own queued message; one epoll (re)arm at the end.
int tb_bus_sendv(tb_bus* bus, int conn, const uint8_t* const* bufs,
                 const uint32_t* lens, uint32_t k) {
    auto it = bus->conns.find(conn);
    if (it == bus->conns.end()) return -1;
    Connection& c = it->second;
    for (uint32_t i = 0; i < k; i++) {
        c.send_queue.emplace_back(bufs[i], bufs[i] + lens[i]);
    }
    bus_arm(bus, c);
    return 0;
}

static void bus_close_conn(tb_bus* bus, int id) {
    auto it = bus->conns.find(id);
    if (it == bus->conns.end()) return;
    epoll_ctl(bus->epfd, EPOLL_CTL_DEL, it->second.fd, nullptr);
    close(it->second.fd);
    bus->fd_to_conn.erase(it->second.fd);
    bus->conns.erase(it);
    bus->events.push_back({4, id, nullptr, 0});
}

void tb_bus_close(tb_bus* bus, int conn) { bus_close_conn(bus, conn); }

static void bus_drain_recv(tb_bus* bus, int id, Connection& c) {
    // Extract complete messages: size u32 at header offset 144.
    size_t at = 0;
    while (c.recv_buf.size() - at >= HEADER_SIZE) {
        uint32_t size = get_u32(c.recv_buf.data() + at + SIZE_OFFSET);
        if (size < HEADER_SIZE || size > bus->message_size_max + HEADER_SIZE) {
            bus_close_conn(bus, id);
            return;
        }
        if (c.recv_buf.size() - at < size) break;
        bus->held.emplace_back(c.recv_buf.begin() + at,
                               c.recv_buf.begin() + at + size);
        bus->events.push_back(
            {3, id, bus->held.back().data(), size});
        at += size;
    }
    if (at) c.recv_buf.erase(c.recv_buf.begin(), c.recv_buf.begin() + at);
}

int tb_bus_poll(tb_bus* bus, int timeout_ms) {
    // Reclaim buffers whose message events were consumed before this
    // poll (their data pointers were only promised valid until now);
    // buffers for still-queued events stay (partial drains — arena
    // full — leave events queued across polls).
    while (bus->held_consumed > 0 && !bus->held.empty()) {
        bus->held.pop_front();
        bus->held_consumed--;
    }
    if (bus->events.empty()) {
        bus->held.clear();
        bus->held_consumed = 0;
    }
    epoll_event evs[64];
    int n = epoll_wait(bus->epfd, evs, 64, timeout_ms);
    for (int i = 0; i < n; i++) {
        int fd = evs[i].data.fd;
        if (fd == bus->listen_fd) {
            for (;;) {
                int cfd = accept(bus->listen_fd, nullptr, nullptr);
                if (cfd < 0) break;
                set_nonblocking(cfd);
                int one = 1;
                setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
                int id = bus->next_conn++;
                Connection& c = bus->conns[id];
                c.fd = cfd;
                bus->fd_to_conn[cfd] = id;
                epoll_event ev{};
                ev.events = EPOLLIN;
                ev.data.fd = cfd;
                epoll_ctl(bus->epfd, EPOLL_CTL_ADD, cfd, &ev);
                bus->events.push_back({1, id, nullptr, 0});
            }
            continue;
        }
        auto cit = bus->fd_to_conn.find(fd);
        if (cit == bus->fd_to_conn.end()) continue;
        int id = cit->second;
        Connection& c = bus->conns[id];

        if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
            bus_close_conn(bus, id);
            continue;
        }
        if (evs[i].events & EPOLLOUT) {
            if (c.connecting) {
                int err = 0;
                socklen_t len = sizeof(err);
                getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
                if (err) { bus_close_conn(bus, id); continue; }
                c.connecting = false;
                bus->events.push_back({2, id, nullptr, 0});
            }
            while (!c.send_queue.empty()) {
                auto& front = c.send_queue.front();
                ssize_t w = ::send(fd, front.data() + c.send_offset,
                                   front.size() - c.send_offset, MSG_NOSIGNAL);
                if (w < 0) break;
                c.send_offset += size_t(w);
                if (c.send_offset == front.size()) {
                    c.send_queue.pop_front();
                    c.send_offset = 0;
                }
            }
            bus_arm(bus, c);
        }
        if (evs[i].events & EPOLLIN) {
            uint8_t tmp[65536];
            for (;;) {
                ssize_t r = recv(fd, tmp, sizeof(tmp), 0);
                if (r > 0) {
                    c.recv_buf.insert(c.recv_buf.end(), tmp, tmp + r);
                } else if (r == 0) {
                    bus_close_conn(bus, id);
                    break;
                } else {
                    break;  // EAGAIN
                }
            }
            if (bus->conns.count(id)) bus_drain_recv(bus, id, c);
        }
    }
    return int(bus->events.size());
}

int tb_bus_next_event(tb_bus* bus, tb_event* out) {
    if (bus->events.empty()) return 0;
    *out = bus->events.front();
    bus->events.pop_front();
    if (out->type == 3 && out->len) bus->held_consumed++;
    return 1;
}

// One-call drain for the columnar ingest fast path: poll, then copy
// every pending event out in one pass — message payloads packed
// back-to-back into `arena`, one (type, conn, offset, len) row per
// event.  Returns the number of events emitted; events that don't fit
// this arena stay queued for the next call (their buffers are held
// until consumed — see tb_bus_poll).  This replaces the per-event
// ctypes round trip AND hands Python one contiguous buffer the batch
// decoder (tb_fastpath tb_fp_verify_frames) can verify in one pass.
int tb_bus_poll_drain(tb_bus* bus, int timeout_ms, uint8_t* arena,
                      uint64_t arena_cap, int32_t* types, int32_t* conns,
                      uint64_t* offsets, uint32_t* lens,
                      int32_t max_events) {
    tb_bus_poll(bus, timeout_ms);
    int32_t n = 0;
    uint64_t at = 0;
    while (n < max_events && !bus->events.empty()) {
        const tb_event& ev = bus->events.front();
        if (ev.type == 3 && ev.len) {
            if (at + ev.len > arena_cap) break;  // next call resumes
            memcpy(arena + at, ev.data, ev.len);
            offsets[n] = at;
            lens[n] = ev.len;
            at += ev.len;
            bus->held_consumed++;  // copied out: reclaim at next poll
        } else {
            offsets[n] = at;
            lens[n] = 0;
        }
        types[n] = ev.type;
        conns[n] = ev.conn;
        bus->events.pop_front();
        n++;
    }
    return n;
}

// ----------------------------------------------------------------------
// Wire helpers (header checksum discipline, C side).

void tb_header_finalize(uint8_t* header, const uint8_t* body, uint32_t body_len) {
    put_u32(header + SIZE_OFFSET, HEADER_SIZE + body_len);
    uint64_t cb[2];
    tb::checksum128(body, body_len, cb);
    put_u64(header + OFF_CHECKSUM_BODY, cb[0]);
    put_u64(header + OFF_CHECKSUM_BODY + 8, cb[1]);
    uint64_t cs[2];
    tb::checksum128(header + 16, HEADER_SIZE - 16, cs);
    put_u64(header + OFF_CHECKSUM, cs[0]);
    put_u64(header + OFF_CHECKSUM + 8, cs[1]);
}

int tb_header_verify(const uint8_t* header, const uint8_t* body,
                     uint32_t body_len) {
    uint64_t cs[2];
    tb::checksum128(header + 16, HEADER_SIZE - 16, cs);
    uint8_t want[16];
    memcpy(want, header + OFF_CHECKSUM, 16);
    uint8_t got[16];
    memcpy(got, cs, 16);
    if (memcmp(want, got, 16) != 0) return 0;
    if (body) {
        uint64_t cb[2];
        tb::checksum128(body, body_len, cb);
        if (memcmp(header + OFF_CHECKSUM_BODY, cb, 16) != 0) return 0;
    }
    return 1;
}

// ----------------------------------------------------------------------
// Client session (the tb_client analog): synchronous request/reply.

struct tb_client {
    tb_bus* bus = nullptr;
    int conn = -1;
    uint64_t cluster = 0;
    uint64_t client_lo = 0, client_hi = 0;
    uint32_t request_number = 0;
    bool registered = false;
    std::string host;
    uint16_t port = 0;
    // Additional cluster addresses: retransmits rotate through them so
    // a view change (new primary without this client's conn) recovers
    // — the reference client similarly re-targets replicas on timeout
    // (src/vsr/client.zig).
    std::vector<std::pair<std::string, uint16_t>> extra_addrs;
    std::vector<int> extra_conns;
    size_t target = 0;  // 0 = primary conn, 1.. = extra
    std::vector<uint8_t> reply;
    int32_t last_status = 0;  // 0 ok, -2 evicted, -3 timeout, -4 io
};

static int client_connect(tb_client* c) {
    c->conn = tb_bus_connect(c->bus, c->host.c_str(), c->port);
    return c->conn >= 0 ? 0 : -1;
}

static int client_conn_for_target(tb_client* c) {
    if (c->target == 0 || c->extra_addrs.empty()) {
        if (c->conn < 0) client_connect(c);  // primary died: reconnect
        return c->conn;
    }
    size_t idx = (c->target - 1) % c->extra_addrs.size();
    while (c->extra_conns.size() <= idx) c->extra_conns.push_back(-1);
    if (c->extra_conns[idx] < 0) {
        c->extra_conns[idx] = tb_bus_connect(
            c->bus, c->extra_addrs[idx].first.c_str(),
            c->extra_addrs[idx].second);
    }
    return c->extra_conns[idx] >= 0 ? c->extra_conns[idx] : c->conn;
}

// A closed connection must not abort the request when other replicas
// (or a reconnect) can still serve it — invalidate the cached id and
// let the retransmission rotation recover.
static void client_note_closed(tb_client* c, int conn) {
    if (conn == c->conn) c->conn = -1;
    for (auto& ec : c->extra_conns)
        if (ec == conn) ec = -1;
}

tb_client* tb_client_init(const char* host, uint16_t port, uint64_t cluster,
                          uint64_t client_lo, uint64_t client_hi) {
    tb_client* c = new tb_client();
    c->bus = tb_bus_create(0);
    c->cluster = cluster;
    c->client_lo = client_lo;
    c->client_hi = client_hi;
    c->host = host;
    c->port = port;
    if (!c->bus || client_connect(c) < 0) {
        tb_bus_destroy(c->bus);
        delete c;
        return nullptr;
    }
    return c;
}

void tb_client_add_address(tb_client* c, const char* host, uint16_t port) {
    c->extra_addrs.emplace_back(host, port);
}

void tb_client_deinit(tb_client* c) {
    if (!c) return;
    tb_bus_destroy(c->bus);
    delete c;
}

// Send one request and wait for its reply.  Returns reply body length
// (>= 0) or a negative status.
static int64_t client_roundtrip(tb_client* c, uint8_t operation,
                                uint32_t request_number, const uint8_t* body,
                                uint32_t body_len, uint8_t* reply_buf,
                                uint32_t reply_cap, int timeout_ms) {
    uint8_t header[HEADER_SIZE];
    memset(header, 0, sizeof(header));
    header[OFF_COMMAND] = CMD_REQUEST;
    header[OFF_OPERATION] = operation;
    header[OFF_VERSION] = WIRE_VERSION;
    put_u64(header + OFF_CLUSTER, c->cluster);
    put_u64(header + OFF_CLIENT, c->client_lo);
    put_u64(header + OFF_CLIENT + 8, c->client_hi);
    put_u32(header + OFF_REQUEST, request_number);
    tb_header_finalize(header, body, body_len);

    std::vector<uint8_t> msg(header, header + HEADER_SIZE);
    msg.insert(msg.end(), body, body + body_len);
    // A failed initial send is not fatal: the retransmission loop
    // rotates targets (and reconnects) until the timeout.
    tb_bus_send(c->bus, client_conn_for_target(c), msg.data(),
                uint32_t(msg.size()));

    int waited = 0;
    const int step = 10;
    // Retransmit cadence: a lost reply (or a request that landed while
    // the primary was mid-repair or mid-view-change) is recovered by
    // resending the SAME request — session dedupe returns the stored
    // reply, so repeats are harmless — ROTATING through the cluster
    // addresses so a new primary that lacks this client's connection
    // learns it (reference: src/vsr/client.zig request_timeout
    // retransmission + replica re-targeting).
    int next_retransmit = 1000;
    while (waited <= timeout_ms) {
        tb_bus_poll(c->bus, step);
        waited += step;
        if (waited >= next_retransmit) {
            next_retransmit += 1000;
            if (!c->extra_addrs.empty())
                c->target = (c->target + 1) % (c->extra_addrs.size() + 1);
            int conn = client_conn_for_target(c);
            if (conn < 0 && c->extra_addrs.empty())
                return -4;  // single address, reconnect refused: fail fast
            tb_bus_send(c->bus, conn, msg.data(), uint32_t(msg.size()));
        }
        tb_event ev;
        while (tb_bus_next_event(c->bus, &ev)) {
            if (ev.type == 4) {  // closed: rotation/reconnect recovers
                client_note_closed(c, ev.conn);
                continue;
            }
            if (ev.type != 3) continue;
            const uint8_t* h = ev.data;
            uint32_t size = get_u32(h + SIZE_OFFSET);
            const uint8_t* rbody = h + HEADER_SIZE;
            uint32_t rbody_len = size - HEADER_SIZE;
            if (!tb_header_verify(h, rbody, rbody_len)) continue;
            if (h[OFF_COMMAND] == CMD_EVICTION) return -2;
            if (h[OFF_COMMAND] != CMD_REPLY) continue;
            if (get_u32(h + OFF_REQUEST) != request_number) continue;
            if (rbody_len > reply_cap) return -5;
            memcpy(reply_buf, rbody, rbody_len);
            return int64_t(rbody_len);
        }
    }
    return -3;  // timeout
}

int64_t tb_client_request(tb_client* c, uint8_t operation, const uint8_t* body,
                          uint32_t body_len, uint8_t* reply_buf,
                          uint32_t reply_cap, int timeout_ms) {
    if (!c->registered) {
        int64_t rc = client_roundtrip(c, OP_REGISTER, 0, nullptr, 0, reply_buf,
                                      reply_cap, timeout_ms);
        if (rc < 0) return rc;
        c->registered = true;
    }
    c->request_number += 1;
    return client_roundtrip(c, operation, c->request_number, body, body_len,
                            reply_buf, reply_cap, timeout_ms);
}

// Checksum export for parity tests.
void tb_checksum128(const uint8_t* data, uint64_t len, uint64_t out[2]) {
    tb::checksum128(data, size_t(len), out);
}

}  // extern "C"

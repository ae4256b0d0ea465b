// tb_async: asynchronous packet-based client (the tb_client analog).
//
// The reference's tb_client is a submission-queue + completion-callback
// API around one VSR client session, with a dedicated IO thread and
// signal-based wakeup (reference: src/clients/c/tb_client.zig:1-142,
// src/clients/c/tb_client/context.zig, signal.zig).  This is the same
// design on the tigerbeetle_tpu wire protocol:
//
//  - callers submit tb_packet_t's from any thread onto an intrusive
//    lock-protected queue and wake the IO thread via an eventfd;
//  - the IO thread owns the socket: it registers the session, keeps
//    ONE request in flight (the VSR session invariant — request
//    numbers are strictly increasing and the server replays the stored
//    reply on retransmission, tigerbeetle_tpu_torch/vsr/multi.py), and
//    coalesces consecutive queued packets of the same batchable
//    operation (create_accounts / create_transfers — reference
//    batch_logical_allowed, src/state_machine.zig:122-131) into one
//    wire request up to batch_max events;
//  - replies are demultiplexed back onto packets: create_* results
//    carry {index, result} pairs which are re-based per packet, so a
//    packet sees exactly its own failures with its own indexing;
//  - completions fire on the IO thread, out of submission order when
//    batching overtakes (a create packet submitted after a lookup can
//    complete first by riding an earlier create request).
//
// Reconnects retransmit the in-flight request under the same request
// number; the server's at-most-once session dedupe turns that into a
// stored-reply replay, so a request is never executed twice.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include "tb_client.h"

// From tb_runtime.cpp (same shared library).
extern "C" void tb_header_finalize(uint8_t* header, const uint8_t* body,
                                   uint32_t body_len);
extern "C" int tb_header_verify(const uint8_t* header, const uint8_t* body,
                                uint32_t body_len);

namespace {

constexpr uint32_t HEADER_SIZE = 256;
constexpr uint32_t MESSAGE_BODY_MAX = (1u << 20) - HEADER_SIZE;
constexpr uint32_t SIZE_OFFSET = 144;
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

// Wire event size per operation; 0 = unknown operation.
uint32_t event_size_of(uint8_t op) {
    switch (op) {
        case TB_OPERATION_CREATE_ACCOUNTS:
        case TB_OPERATION_CREATE_TRANSFERS:
            return 128;
        case TB_OPERATION_LOOKUP_ACCOUNTS:
        case TB_OPERATION_LOOKUP_TRANSFERS:
            return 16;
        case TB_OPERATION_GET_ACCOUNT_TRANSFERS:
        case TB_OPERATION_GET_ACCOUNT_BALANCES:
            return 64;  // one AccountFilter (types.py ACCOUNT_FILTER_DTYPE)
        default:
            return 0;
    }
}

bool batchable(uint8_t op) {
    return op == TB_OPERATION_CREATE_ACCOUNTS ||
           op == TB_OPERATION_CREATE_TRANSFERS;
}

// Max events per request: bounded by the 1 MiB message for the events
// themselves AND by the reply (lookups return 128-byte rows per event).
uint32_t batch_max_of(uint8_t op) {
    uint32_t esize = event_size_of(op);
    uint32_t by_request = MESSAGE_BODY_MAX / esize;
    uint32_t by_reply = MESSAGE_BODY_MAX / 128u;
    return by_request < by_reply ? by_request : by_reply;
}

}  // namespace

extern "C" {

struct tb_async_client {
    std::string host;
    uint16_t port = 0;
    uint64_t cluster = 0;
    uint64_t client_lo = 0, client_hi = 0;
    tb_async_on_completion on_completion = nullptr;
    void* ctx = nullptr;

    std::mutex mu;
    tb_packet_t* q_head = nullptr;
    tb_packet_t* q_tail = nullptr;
    bool paused = false;
    bool shutdown = false;
    int event_fd = -1;
    std::thread io;

    // IO-thread state.
    int fd = -1;
    bool registered = false;
    uint32_t request_number = 0;
    bool evicted = false;
    // In-flight request: the packets it carries, each packet's event
    // count, and the full wire message for retransmission.
    std::vector<tb_packet_t*> inflight;
    std::vector<uint32_t> inflight_events;
    std::vector<uint8_t> inflight_msg;
    std::vector<uint8_t> recv_buf;
};

static void complete(tb_async_client* c, tb_packet_t* p, uint8_t status,
                     const uint8_t* reply, uint32_t reply_len) {
    p->status = status;
    p->next = nullptr;
    c->on_completion(c->ctx, p, status == TB_PACKET_OK ? reply : nullptr,
                     status == TB_PACKET_OK ? reply_len : 0);
}

static void wake(tb_async_client* c) {
    uint64_t one = 1;
    ssize_t rc = write(c->event_fd, &one, 8);
    (void)rc;
}

// --- IO thread ------------------------------------------------------

static bool send_all(tb_async_client* c, const uint8_t* data, size_t len) {
    size_t at = 0;
    while (at < len) {
        ssize_t w = send(c->fd, data + at, len - at, MSG_NOSIGNAL);
        if (w > 0) {
            at += size_t(w);
            continue;
        }
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            pollfd pf{c->fd, POLLOUT, 0};
            poll(&pf, 1, 100);
            {
                std::lock_guard<std::mutex> g(c->mu);
                if (c->shutdown) return false;
            }
            continue;
        }
        return false;
    }
    return true;
}

static bool io_connect(tb_async_client* c) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return false;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(c->port);
    inet_pton(AF_INET, c->host.c_str(), &addr.sin_addr);
    if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
        close(fd);
        return false;
    }
    c->fd = fd;
    c->recv_buf.clear();
    return true;
}

static void build_request(tb_async_client* c, uint8_t operation,
                          uint32_t request_number, const uint8_t* body,
                          uint32_t body_len, std::vector<uint8_t>* out) {
    out->assign(HEADER_SIZE + body_len, 0);
    uint8_t* h = out->data();
    h[OFF_COMMAND] = CMD_REQUEST;
    h[OFF_OPERATION] = operation;
    h[OFF_VERSION] = WIRE_VERSION;
    put_u64(h + OFF_CLUSTER, c->cluster);
    put_u64(h + OFF_CLIENT, c->client_lo);
    put_u64(h + OFF_CLIENT + 8, c->client_hi);
    put_u32(h + OFF_REQUEST, request_number);
    if (body_len) memcpy(out->data() + HEADER_SIZE, body, body_len);
    tb_header_finalize(h, out->data() + HEADER_SIZE, body_len);
}

// Pop the next request's worth of packets off the submission queue
// (coalescing batchable same-operation runs) and send it.  Packets are
// validated at submit time, so the queue only holds well-formed ones.
// Caller holds no lock.
static void io_pump_submissions(tb_async_client* c) {
    if (!c->inflight.empty() || !c->registered) return;
    for (;;) {
        std::vector<tb_packet_t*> take;
        {
            std::lock_guard<std::mutex> g(c->mu);
            if (c->paused || c->q_head == nullptr) return;
            tb_packet_t* first = c->q_head;
            uint32_t esize = event_size_of(first->operation);
            uint32_t max_events = batch_max_of(first->operation);
            if (!batchable(first->operation)) {
                c->q_head = first->next;
                if (!c->q_head) c->q_tail = nullptr;
                take.push_back(first);
            } else {
                // Coalesce queued packets of this operation (not just
                // a consecutive run — the reference links
                // same-operation packets across the queue) within
                // batch_max; other operations keep their queue
                // positions.  The scan STOPS at the first same-op
                // packet that does not fit: same-operation packets
                // must never overtake each other in execution order
                // (a later create may post a pending created by an
                // earlier one).
                uint32_t total = 0;
                tb_packet_t** link = &c->q_head;
                while (*link) {
                    tb_packet_t* p = *link;
                    if (p->operation == first->operation) {
                        uint32_t ev = p->data_size / esize;
                        if (total + ev > max_events) break;
                        total += ev;
                        take.push_back(p);
                        *link = p->next;
                    } else {
                        link = &p->next;
                    }
                }
                c->q_tail = nullptr;
                for (tb_packet_t* p = c->q_head; p; p = p->next)
                    c->q_tail = p;
            }
        }
        if (c->evicted) {
            for (tb_packet_t* p : take)
                complete(c, p, TB_PACKET_CLIENT_EVICTED, nullptr, 0);
            continue;
        }

        // Build the coalesced body.
        uint32_t esize = event_size_of(take[0]->operation);
        std::vector<uint8_t> body;
        c->inflight_events.clear();
        for (tb_packet_t* p : take) {
            body.insert(body.end(), static_cast<const uint8_t*>(p->data),
                        static_cast<const uint8_t*>(p->data) + p->data_size);
            c->inflight_events.push_back(p->data_size / esize);
        }
        c->request_number += 1;
        build_request(c, take[0]->operation, c->request_number, body.data(),
                      uint32_t(body.size()), &c->inflight_msg);
        c->inflight = std::move(take);
        send_all(c, c->inflight_msg.data(), c->inflight_msg.size());
        return;  // one request in flight
    }
}

// Demultiplex a create_* reply: {index u32, result u32} entries sorted
// by index; each packet owns indices [base, base + events).  Indices
// are re-based in place so every packet sees its own 0-based slice.
static void io_complete_create_reply(tb_async_client* c, uint8_t* rbody,
                                     uint32_t rlen) {
    uint32_t n_entries = rlen / 8;
    uint32_t entry_at = 0;
    uint64_t base = 0;
    for (size_t k = 0; k < c->inflight.size(); k++) {
        uint32_t events = c->inflight_events[k];
        uint32_t start = entry_at;
        while (entry_at < n_entries &&
               get_u32(rbody + size_t(entry_at) * 8) < base + events) {
            put_u32(rbody + size_t(entry_at) * 8,
                    uint32_t(get_u32(rbody + size_t(entry_at) * 8) - base));
            entry_at++;
        }
        complete(c, c->inflight[k], TB_PACKET_OK, rbody + size_t(start) * 8,
                 (entry_at - start) * 8);
        base += events;
    }
}

static void io_on_message(tb_async_client* c, uint8_t* msg, uint32_t size) {
    uint8_t* body = msg + HEADER_SIZE;
    uint32_t body_len = size - HEADER_SIZE;
    if (!tb_header_verify(msg, body, body_len)) return;
    if (msg[OFF_COMMAND] == CMD_EVICTION) {
        c->evicted = true;
        for (tb_packet_t* p : c->inflight)
            complete(c, p, TB_PACKET_CLIENT_EVICTED, nullptr, 0);
        c->inflight.clear();
        return;
    }
    if (msg[OFF_COMMAND] != CMD_REPLY) return;
    uint32_t req = get_u32(msg + OFF_REQUEST);
    if (msg[OFF_OPERATION] == OP_REGISTER) {
        if (!c->registered && req == 0) c->registered = true;
        return;
    }
    if (c->inflight.empty() || req != c->request_number) return;
    uint8_t op = c->inflight[0]->operation;
    if (msg[OFF_OPERATION] != op) return;
    if (batchable(op)) {
        io_complete_create_reply(c, body, body_len);
        c->inflight.clear();
    } else {
        tb_packet_t* p = c->inflight[0];
        c->inflight.clear();
        complete(c, p, TB_PACKET_OK, body, body_len);
    }
}

static void io_drain_socket(tb_async_client* c) {
    uint8_t tmp[65536];
    for (;;) {
        ssize_t r = recv(c->fd, tmp, sizeof(tmp), MSG_DONTWAIT);
        if (r > 0) {
            c->recv_buf.insert(c->recv_buf.end(), tmp, tmp + r);
        } else if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
            close(c->fd);
            c->fd = -1;
            return;
        } else {
            break;
        }
    }
    size_t at = 0;
    while (c->recv_buf.size() - at >= HEADER_SIZE) {
        uint32_t size = get_u32(c->recv_buf.data() + at + SIZE_OFFSET);
        if (size < HEADER_SIZE || size > HEADER_SIZE + MESSAGE_BODY_MAX) {
            close(c->fd);
            c->fd = -1;
            return;
        }
        if (c->recv_buf.size() - at < size) break;
        io_on_message(c, c->recv_buf.data() + at, size);
        at += size;
    }
    if (at) c->recv_buf.erase(c->recv_buf.begin(), c->recv_buf.begin() + at);
}

static void io_thread_main(tb_async_client* c) {
    std::vector<uint8_t> reg_msg;
    int backoff_ms = 10;
    for (;;) {
        {
            std::lock_guard<std::mutex> g(c->mu);
            if (c->shutdown) break;
        }
        if (c->fd < 0) {
            if (!io_connect(c)) {
                pollfd pf{c->event_fd, POLLIN, 0};
                poll(&pf, 1, backoff_ms);
                uint64_t v;
                ssize_t rc = read(c->event_fd, &v, 8);
                (void)rc;
                backoff_ms = backoff_ms < 1000 ? backoff_ms * 2 : 1000;
                continue;
            }
            backoff_ms = 10;
            // (Re-)register, then retransmit any in-flight request:
            // the server's session dedupe replays the stored reply if
            // it already committed.
            c->registered = false;
            build_request(c, OP_REGISTER, 0, nullptr, 0, &reg_msg);
            send_all(c, reg_msg.data(), reg_msg.size());
            if (!c->inflight.empty())
                send_all(c, c->inflight_msg.data(), c->inflight_msg.size());
        }

        io_pump_submissions(c);

        pollfd pfs[2] = {{c->fd, POLLIN, 0}, {c->event_fd, POLLIN, 0}};
        poll(pfs, 2, 100);
        if (pfs[1].revents & POLLIN) {
            uint64_t v;
            ssize_t rc = read(c->event_fd, &v, 8);
            (void)rc;
        }
        if (pfs[0].revents & (POLLIN | POLLHUP | POLLERR)) io_drain_socket(c);
    }

    // Shutdown: everything not completed fails with CLIENT_SHUTDOWN.
    for (tb_packet_t* p : c->inflight)
        complete(c, p, TB_PACKET_CLIENT_SHUTDOWN, nullptr, 0);
    c->inflight.clear();
    for (;;) {
        tb_packet_t* p;
        {
            std::lock_guard<std::mutex> g(c->mu);
            p = c->q_head;
            if (p) {
                c->q_head = p->next;
                if (!c->q_head) c->q_tail = nullptr;
            }
        }
        if (!p) break;
        complete(c, p, TB_PACKET_CLIENT_SHUTDOWN, nullptr, 0);
    }
    if (c->fd >= 0) close(c->fd);
}

// --- Public API -----------------------------------------------------

tb_async_client_t* tb_async_init(const char* host, uint16_t port,
                                 uint64_t cluster, uint64_t client_lo,
                                 uint64_t client_hi,
                                 tb_async_on_completion on_completion,
                                 void* completion_context) {
    in_addr scratch;
    if (inet_pton(AF_INET, host, &scratch) != 1) return nullptr;
    tb_async_client* c = new tb_async_client();
    c->host = host;
    c->port = port;
    c->cluster = cluster;
    c->client_lo = client_lo;
    c->client_hi = client_hi;
    c->on_completion = on_completion;
    c->ctx = completion_context;
    c->event_fd = eventfd(0, EFD_NONBLOCK);
    if (c->event_fd < 0) {
        delete c;
        return nullptr;
    }
    c->io = std::thread(io_thread_main, c);
    return c;
}

int tb_async_submit(tb_async_client_t* c, tb_packet_t* p) {
    uint32_t esize = event_size_of(p->operation);
    if (esize == 0) {
        complete(c, p, TB_PACKET_INVALID_OPERATION, nullptr, 0);
        return -1;
    }
    if (p->data_size % esize != 0) {
        complete(c, p, TB_PACKET_INVALID_DATA_SIZE, nullptr, 0);
        return -1;
    }
    // Query operations take exactly one AccountFilter.
    if ((p->operation == TB_OPERATION_GET_ACCOUNT_TRANSFERS ||
         p->operation == TB_OPERATION_GET_ACCOUNT_BALANCES) &&
        p->data_size != esize) {
        complete(c, p, TB_PACKET_INVALID_DATA_SIZE, nullptr, 0);
        return -1;
    }
    if (p->data_size / esize > batch_max_of(p->operation)) {
        complete(c, p, TB_PACKET_TOO_MUCH_DATA, nullptr, 0);
        return -1;
    }
    p->next = nullptr;
    p->status = TB_PACKET_OK;
    {
        std::lock_guard<std::mutex> g(c->mu);
        if (c->shutdown) {
            // Completing under the lock would be rude; do it outside.
        } else {
            if (c->q_tail) {
                c->q_tail->next = p;
            } else {
                c->q_head = p;
            }
            c->q_tail = p;
            p = nullptr;
        }
    }
    if (p) {
        complete(c, p, TB_PACKET_CLIENT_SHUTDOWN, nullptr, 0);
        return -1;
    }
    wake(c);
    return 0;
}

void tb_async_pause(tb_async_client_t* c) {
    std::lock_guard<std::mutex> g(c->mu);
    c->paused = true;
}

void tb_async_resume(tb_async_client_t* c) {
    {
        std::lock_guard<std::mutex> g(c->mu);
        c->paused = false;
    }
    wake(c);
}

void tb_async_deinit(tb_async_client_t* c) {
    if (!c) return;
    {
        std::lock_guard<std::mutex> g(c->mu);
        c->shutdown = true;
    }
    wake(c);
    if (c->io.joinable()) c->io.join();
    close(c->event_fd);
    delete c;
}

}  // extern "C"

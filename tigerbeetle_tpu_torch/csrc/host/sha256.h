// Compact SHA-256 (FIPS 180-4), used for the wire/disk checksum
// discipline (truncated to 128 bits — see tigerbeetle_tpu_torch/vsr/wire.py;
// the reference uses AEGIS-128L instead: /root/reference
// src/vsr/checksum.zig, but this build standardizes on SHA-256 so the
// host Python side can use hashlib with identical results).
#pragma once
#include <cstdint>
#include <cstring>

#include <dlfcn.h>

namespace tb {

struct Sha256 {
    uint32_t h[8];
    uint64_t len = 0;
    uint8_t buf[64];
    size_t buf_len = 0;

    Sha256() {
        static const uint32_t init[8] = {
            0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
        };
        memcpy(h, init, sizeof(h));
    }

    static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

    void block(const uint8_t* p) {
        static const uint32_t k[64] = {
            0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
            0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
            0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
            0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
            0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
            0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
            0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
            0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
            0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
            0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
            0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
            0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
            0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
        };
        uint32_t w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
                   (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + s1 + ch + k[i] + w[i];
            uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = s0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }

    void update(const void* data, size_t n) {
        const uint8_t* p = static_cast<const uint8_t*>(data);
        len += n;
        if (buf_len) {
            while (n && buf_len < 64) { buf[buf_len++] = *p++; n--; }
            if (buf_len == 64) { block(buf); buf_len = 0; }
        }
        while (n >= 64) { block(p); p += 64; n -= 64; }
        while (n) { buf[buf_len++] = *p++; n--; }
    }

    void final(uint8_t out[32]) {
        uint64_t bits = len * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t zero = 0;
        while (buf_len != 56) update(&zero, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
        update(lenb, 8);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = uint8_t(h[i] >> 24);
            out[4 * i + 1] = uint8_t(h[i] >> 16);
            out[4 * i + 2] = uint8_t(h[i] >> 8);
            out[4 * i + 3] = uint8_t(h[i]);
        }
    }
};

// One-shot SHA-256 through the system libcrypto when present: OpenSSL
// carries SHA-NI/AVX2 kernels (~8x the scalar loop above on this
// class of host — measured 1.85 GB/s vs 225 MB/s), and hashlib on the
// Python side uses the same library, so results are identical by
// construction.  Resolved once via dlopen so no build-time OpenSSL
// headers are needed; the scalar struct stays as the portable
// fallback and the streaming API.
//
// Round 23: the EVP one-shot (EVP_Digest + EVP_sha256) resolves FIRST
// — it is OpenSSL 3's blessed dispatch into the fetched provider
// implementation (SHA-NI where the CPU has it), while the legacy
// SHA256() entry goes through a compat bridge.  The dlopen fallback
// chain is unchanged; sha256_engine() reports which tier actually
// resolved so benches and the scalar-fallback warning can name it.
typedef unsigned char* (*sha256_oneshot_fn)(const unsigned char*, size_t,
                                            unsigned char*);
typedef int (*evp_digest_fn)(const void*, size_t, unsigned char*,
                             unsigned int*, const void*, void*);
typedef const void* (*evp_md_fn)(void);

enum Sha256Engine {
    SHA256_ENGINE_EVP = 1,     // EVP_Digest(EVP_sha256()) one-shot
    SHA256_ENGINE_LEGACY = 2,  // legacy SHA256() one-shot
    SHA256_ENGINE_SCALAR = 3,  // the portable struct above (~225 MB/s)
};

struct Sha256Impl {
    evp_digest_fn evp = nullptr;
    const void* evp_md = nullptr;
    sha256_oneshot_fn legacy = nullptr;
};

inline const Sha256Impl& sha256_impl() {
    static Sha256Impl impl = []() -> Sha256Impl {
        Sha256Impl r;
        for (const char* name :
             {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"}) {
            if (void* h = dlopen(name, RTLD_NOW | RTLD_LOCAL)) {
                void* dig = dlsym(h, "EVP_Digest");
                void* md = dlsym(h, "EVP_sha256");
                if (dig && md) {
                    r.evp = reinterpret_cast<evp_digest_fn>(dig);
                    r.evp_md = reinterpret_cast<evp_md_fn>(md)();
                }
                if (void* sym = dlsym(h, "SHA256"))
                    r.legacy = reinterpret_cast<sha256_oneshot_fn>(sym);
                if (r.evp || r.legacy) return r;
                dlclose(h);
            }
        }
        return r;
    }();
    return impl;
}

// Engine override for the --hash-only bench grid (0 = auto-resolve).
// Forcing a tier that did not resolve degrades to the next one down,
// exactly as auto-resolution would.
inline int& sha256_force() {
    static int force = 0;
    return force;
}

inline int sha256_engine() {
    const Sha256Impl& impl = sha256_impl();
    int force = sha256_force();
    if (force == SHA256_ENGINE_SCALAR) return SHA256_ENGINE_SCALAR;
    if (impl.evp && impl.evp_md && force != SHA256_ENGINE_LEGACY)
        return SHA256_ENGINE_EVP;
    if (impl.legacy) return SHA256_ENGINE_LEGACY;
    return SHA256_ENGINE_SCALAR;
}

inline void sha256_digest(const void* data, size_t n, uint8_t out[32]) {
    const Sha256Impl& impl = sha256_impl();
    switch (sha256_engine()) {
        case SHA256_ENGINE_EVP: {
            unsigned int md_len = 32;
            if (impl.evp(data, n, out, &md_len, impl.evp_md, nullptr))
                return;
            break;  // EVP failure: fall through to the scalar core
        }
        case SHA256_ENGINE_LEGACY:
            impl.legacy(static_cast<const unsigned char*>(data), n, out);
            return;
        default:
            break;
    }
    Sha256 s;
    s.update(data, n);
    s.final(out);
}

// 128-bit truncated checksum, little-endian limbs (parity with
// tigerbeetle_tpu_torch/vsr/wire.py checksum()).
inline void checksum128(const void* data, size_t n, uint64_t out[2]) {
    uint8_t digest[32];
    sha256_digest(data, n, digest);
    uint64_t lo = 0, hi = 0;
    for (int i = 0; i < 8; i++) lo |= uint64_t(digest[i]) << (8 * i);
    for (int i = 0; i < 8; i++) hi |= uint64_t(digest[8 + i]) << (8 * i);
    out[0] = lo;
    out[1] = hi;
}

}  // namespace tb

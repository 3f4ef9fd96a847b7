// slabdb — embedded append-log key-value store for the beacon database.
//
// Native-runtime twin of the reference's LevelDB dependency
// (beacon_node/store/Cargo.toml:13, used by HotColdDB at
// beacon_node/store/src/hot_cold_store.rs:43): the framework's host-side
// storage engine, written in C++ as the reference's store backend is native
// C++ (SURVEY §2.7).  Design favors the beacon workload over generality:
//
//   * values are immutable blobs keyed by (column u8, key bytes) — blocks
//     and states are content-addressed, so overwrites are rare and
//     compaction is simple "copy live set".
//   * writes append to a data log, an in-memory unordered_map indexes
//     offsets.  Every record is framed with a CRC32-C (Castagnoli — the
//     same polynomial LevelDB and the snappy framing use), so replay
//     distinguishes a valid prefix from a torn or bit-flipped tail.
//   * crash safety: `slab_flush` is fflush + fsync; compaction fsyncs the
//     rewritten file AND its directory before the atomic rename-over; open
//     truncates the log to the last CRC-valid record and reports what was
//     kept/dropped (the RecoveryReport surfaced via slab_recovery_*).
//   * deletes are tombstone records; `slab_compact` rewrites the live set.
//
// Log format v2 (magic "SLB2"): per-record `tag u8 | klen u32 | vlen u32 |
// crc u32 | key | value`, crc over the first 9 header bytes + key + value.
// Legacy v1 logs (no CRCs) are replayed once and migrated to v2 in place.
//
// C ABI (consumed via ctypes from lighthouse_tpu/store):
//   slab_open/close/put/get/del/free/count/compact/flush/iter_prefix
//   + slab_recovery_{kept,dropped,truncated,flags}.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <unordered_map>
#include <unistd.h>
#include <vector>

namespace {

struct Rec {
    uint64_t off;   // offset of the value payload in the log
    uint32_t len;   // value length
};

struct Slab {
    FILE* f = nullptr;
    std::string path;
    std::unordered_map<std::string, Rec> index;
    uint64_t end = 0;       // logical end of valid data
    uint64_t dead = 0;      // bytes of dead (overwritten/deleted) payload
    // recovery report, filled once by replay at open
    uint64_t rec_kept = 0;       // records applied from the valid prefix
    uint64_t rec_dropped = 0;    // record frames lost past the valid prefix
    uint64_t rec_truncated = 0;  // bytes cut from the tail
    int tail_torn = 0;           // a torn/corrupt tail was truncated
    int migrated = 0;            // a v1 (no-CRC) log was rewritten as v2
    int crc_failed = 0;          // the tail was cut at a CRC mismatch
};

constexpr uint32_t MAGIC_V1 = 0x534c4142u;  // legacy, no per-record CRC
constexpr uint32_t MAGIC = 0x32424c53u;     // "SLB2": CRC32-C framed records
constexpr uint8_t TAG_PUT = 1;
constexpr uint8_t TAG_DEL = 2;
constexpr size_t HDR = 13;     // tag u8 | klen u32 | vlen u32 | crc u32
constexpr size_t HDR_V1 = 9;   // tag u8 | klen u32 | vlen u32
constexpr uint32_t MAX_KLEN = 1u << 20;
constexpr uint32_t MAX_VLEN = 1u << 30;

// ---------------------------------------------------------------- CRC32-C
// Castagnoli polynomial (reflected 0x82F63B78) — byte-identical to the
// Python table in network/snappy.py, which is the independent verifier.

uint32_t CRC_TABLE[256];
struct CrcInit {
    CrcInit() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            CRC_TABLE[i] = c;
        }
    }
} crc_init_;

uint32_t crc_update(uint32_t crc, const void* data, size_t n) {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    while (n--) crc = CRC_TABLE[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return crc;
}

// ------------------------------------------------------------------- I/O

bool read_exact(FILE* f, void* buf, size_t n) {
    return fread(buf, 1, n, f) == n;
}

// fsync the directory holding `path` so a just-renamed file survives a
// power loss (rename durability needs the directory entry on disk too).
void fsync_dir(const std::string& path) {
    std::string dir = ".";
    auto slash = path.find_last_of('/');
    if (slash != std::string::npos) dir = path.substr(0, slash ? slash : 1);
    int dfd = open(dir.c_str(), O_RDONLY);
    if (dfd >= 0) {
        fsync(dfd);
        close(dfd);
    }
}

int write_record(FILE* f, uint8_t tag, const uint8_t* key, uint32_t klen,
                 const uint8_t* val, uint32_t vlen) {
    uint8_t hdr[HDR];
    hdr[0] = tag;
    memcpy(hdr + 1, &klen, 4);
    memcpy(hdr + 5, &vlen, 4);
    uint32_t c = crc_update(0xFFFFFFFFu, hdr, HDR_V1);
    if (klen) c = crc_update(c, key, klen);
    if (vlen) c = crc_update(c, val, vlen);
    c ^= 0xFFFFFFFFu;
    memcpy(hdr + 9, &c, 4);
    if (fwrite(hdr, 1, HDR, f) != HDR) return -1;
    if (klen && fwrite(key, 1, klen, f) != klen) return -1;
    if (vlen && fwrite(val, 1, vlen, f) != vlen) return -1;
    return 0;
}

// ---------------------------------------------------------------- replay

// Best-effort count of record frames past the valid prefix: walk forward
// accepting any bounds-sane header (no CRC requirement — the point is to
// report how many records the damage swallowed).  A frame whose header
// survived but whose payload runs past EOF (the in-flight write a SIGKILL
// tore) counts as one lost record.
uint64_t count_lost(FILE* f, uint64_t pos, uint64_t fsize, size_t hdr_size) {
    uint64_t n = 0;
    if (fseek(f, (long)pos, SEEK_SET) != 0) return 0;
    for (;;) {
        uint8_t hdr[HDR];
        if (!read_exact(f, hdr, hdr_size)) break;
        uint8_t tag = hdr[0];
        uint32_t klen, vlen;
        memcpy(&klen, hdr + 1, 4);
        memcpy(&vlen, hdr + 5, 4);
        if ((tag != TAG_PUT && tag != TAG_DEL) || klen > MAX_KLEN ||
            vlen > MAX_VLEN)
            break;
        uint64_t body = (uint64_t)klen + (tag == TAG_PUT ? vlen : 0);
        ++n;
        if (pos + hdr_size + body > fsize) break;  // torn in-flight record
        if (fseek(f, (long)body, SEEK_CUR) != 0) break;
        pos += hdr_size + body;
    }
    return n;
}

void apply_record(Slab* s, uint8_t tag, std::string&& key, uint64_t voff,
                  uint32_t vlen) {
    if (tag == TAG_PUT) {
        auto it = s->index.find(key);
        if (it != s->index.end()) s->dead += it->second.len;
        s->index[std::move(key)] = Rec{voff, vlen};
    } else {
        auto it = s->index.find(key);
        if (it != s->index.end()) {
            s->dead += it->second.len;
            s->index.erase(it);
        }
    }
}

// v2 replay: verify every record's CRC; stop at the first torn or corrupt
// frame and truncate the log there so the next append starts on a valid
// record boundary.
bool replay_v2(Slab* s, uint64_t fsize) {
    if (fseek(s->f, 4, SEEK_SET) != 0) return false;
    uint64_t pos = 4;
    std::vector<uint8_t> vbuf;
    for (;;) {
        uint8_t hdr[HDR];
        if (!read_exact(s->f, hdr, HDR)) break;  // clean EOF or torn header
        uint8_t tag = hdr[0];
        uint32_t klen, vlen, crc;
        memcpy(&klen, hdr + 1, 4);
        memcpy(&vlen, hdr + 5, 4);
        memcpy(&crc, hdr + 9, 4);
        if ((tag != TAG_PUT && tag != TAG_DEL) || klen > MAX_KLEN ||
            vlen > MAX_VLEN || (tag == TAG_DEL && vlen != 0))
            break;  // corrupt header
        uint64_t body = (uint64_t)klen + (tag == TAG_PUT ? vlen : 0);
        if (pos + HDR + body > fsize) break;  // torn write (crash mid-value)
        std::string key(klen, '\0');
        if (klen && !read_exact(s->f, key.data(), klen)) break;
        uint32_t c = crc_update(0xFFFFFFFFu, hdr, HDR_V1);
        c = crc_update(c, key.data(), klen);
        if (tag == TAG_PUT && vlen) {
            vbuf.resize(vlen);
            if (!read_exact(s->f, vbuf.data(), vlen)) break;
            c = crc_update(c, vbuf.data(), vlen);
        }
        if ((c ^ 0xFFFFFFFFu) != crc) {  // bit rot / corrupt record
            s->crc_failed = 1;
            break;
        }
        uint64_t voff = pos + HDR + klen;
        apply_record(s, tag, std::move(key), voff, tag == TAG_PUT ? vlen : 0);
        s->rec_kept++;
        pos = pos + HDR + body;
    }
    if (pos < fsize) {
        s->tail_torn = 1;
        s->rec_truncated = fsize - pos;
        s->rec_dropped = count_lost(s->f, pos, fsize, HDR);
        if (ftruncate(fileno(s->f), (off_t)pos) != 0) return false;
    }
    s->end = pos;
    return fseek(s->f, (long)pos, SEEK_SET) == 0;
}

// Legacy v1 replay (no CRCs): same torn-tail truncation, structural checks
// only.  The caller migrates the surviving live set to v2 afterwards.
bool replay_v1(Slab* s, uint64_t fsize) {
    if (fseek(s->f, 4, SEEK_SET) != 0) return false;
    uint64_t pos = 4;
    for (;;) {
        uint8_t hdr[HDR_V1];
        if (!read_exact(s->f, hdr, HDR_V1)) break;
        uint8_t tag = hdr[0];
        uint32_t klen, vlen;
        memcpy(&klen, hdr + 1, 4);
        memcpy(&vlen, hdr + 5, 4);
        if ((tag != TAG_PUT && tag != TAG_DEL) || klen > MAX_KLEN ||
            vlen > MAX_VLEN)
            break;
        uint64_t body = (uint64_t)klen + (tag == TAG_PUT ? vlen : 0);
        if (pos + HDR_V1 + body > fsize) break;
        std::string key(klen, '\0');
        if (klen && !read_exact(s->f, key.data(), klen)) break;
        uint64_t voff = pos + HDR_V1 + klen;
        if (tag == TAG_PUT && vlen &&
            fseek(s->f, (long)vlen, SEEK_CUR) != 0)
            break;
        apply_record(s, tag, std::move(key), voff, tag == TAG_PUT ? vlen : 0);
        s->rec_kept++;
        pos = pos + HDR_V1 + body;
    }
    if (pos < fsize) {
        s->tail_torn = 1;
        s->rec_truncated = fsize - pos;
        s->rec_dropped = count_lost(s->f, pos, fsize, HDR_V1);
        if (ftruncate(fileno(s->f), (off_t)pos) != 0) return false;
    }
    s->end = pos;
    return fseek(s->f, (long)pos, SEEK_SET) == 0;
}

// Rewrite only the live set into a fresh v2 log and atomically swap it in:
// fsync the new file, rename over the old path, fsync the directory.  Used
// by compaction and by the one-shot v1 → v2 migration.
int rewrite_live(Slab* s) {
    std::string tmp = s->path + ".compact";
    FILE* nf = fopen(tmp.c_str(), "w+b");
    if (!nf) return -1;
    if (fwrite(&MAGIC, 4, 1, nf) != 1) { fclose(nf); return -1; }
    std::unordered_map<std::string, Rec> nindex;
    uint64_t nend = 4;
    std::vector<uint8_t> buf;
    for (auto& [k, rec] : s->index) {
        buf.resize(rec.len);
        if (fseek(s->f, (long)rec.off, SEEK_SET) != 0 ||
            (rec.len && !read_exact(s->f, buf.data(), rec.len))) {
            fclose(nf);
            remove(tmp.c_str());
            return -1;
        }
        uint32_t klen = (uint32_t)k.size(), vlen = rec.len;
        if (write_record(nf, TAG_PUT,
                         reinterpret_cast<const uint8_t*>(k.data()), klen,
                         buf.data(), vlen) != 0) {
            fclose(nf);
            remove(tmp.c_str());
            return -1;
        }
        nindex[k] = Rec{nend + HDR + klen, vlen};
        nend += HDR + (uint64_t)klen + vlen;
    }
    // durability order: file contents → rename → directory entry.  A crash
    // before the rename leaves the old log untouched; after it, the new
    // log is complete and fsync'd.
    if (fflush(nf) != 0 || fsync(fileno(nf)) != 0) {
        fclose(nf);
        remove(tmp.c_str());
        return -1;
    }
    if (rename(tmp.c_str(), s->path.c_str()) != 0) {
        // old handle stays valid and open — the store keeps working
        fclose(nf);
        remove(tmp.c_str());
        return -1;
    }
    fsync_dir(s->path);
    fclose(s->f);
    s->f = nf;
    s->index.swap(nindex);
    s->end = nend;
    s->dead = 0;
    return fseek(s->f, (long)nend, SEEK_SET) == 0 ? 0 : -1;
}

bool replay(Slab* s) {
    uint32_t magic = 0;
    if (!read_exact(s->f, &magic, 4)) {  // brand-new file
        if (fseek(s->f, 0, SEEK_SET) != 0) return false;
        if (fwrite(&MAGIC, 4, 1, s->f) != 1) return false;
        if (fflush(s->f) != 0 || fsync(fileno(s->f)) != 0) return false;
        s->end = 4;
        return true;
    }
    if (fseek(s->f, 0, SEEK_END) != 0) return false;
    uint64_t fsize = (uint64_t)ftell(s->f);
    if (magic == MAGIC) return replay_v2(s, fsize);
    if (magic == MAGIC_V1) {
        if (!replay_v1(s, fsize)) return false;
        if (rewrite_live(s) != 0) return false;  // one-shot v1 → v2 upgrade
        s->migrated = 1;
        return true;
    }
    return false;  // unknown magic: refuse to guess
}

}  // namespace

extern "C" {

void* slab_open(const char* path) {
    Slab* s = new Slab();
    s->path = path;
    s->f = fopen(path, "r+b");
    if (!s->f) s->f = fopen(path, "w+b");
    if (!s->f || !replay(s)) {
        if (s->f) fclose(s->f);
        delete s;
        return nullptr;
    }
    return s;
}

void slab_close(void* h) {
    Slab* s = static_cast<Slab*>(h);
    if (s->f) fclose(s->f);
    delete s;
}

int slab_put(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val,
             uint32_t vlen) {
    Slab* s = static_cast<Slab*>(h);
    if (fseek(s->f, (long)s->end, SEEK_SET) != 0) return -1;
    if (write_record(s->f, TAG_PUT, key, klen, val, vlen) != 0) return -1;
    std::string k(reinterpret_cast<const char*>(key), klen);
    auto it = s->index.find(k);
    if (it != s->index.end()) s->dead += it->second.len;
    s->index[k] = Rec{s->end + HDR + klen, vlen};
    s->end += HDR + (uint64_t)klen + vlen;
    return 0;
}

// Returns value length, or -1 if absent. *out is malloc'd; free with
// slab_free.
int64_t slab_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** out) {
    Slab* s = static_cast<Slab*>(h);
    auto it = s->index.find(std::string(reinterpret_cast<const char*>(key), klen));
    if (it == s->index.end()) return -1;
    uint8_t* buf = static_cast<uint8_t*>(malloc(it->second.len ? it->second.len : 1));
    if (fseek(s->f, (long)it->second.off, SEEK_SET) != 0 ||
        (it->second.len && !read_exact(s->f, buf, it->second.len))) {
        free(buf);
        return -1;
    }
    // restore append position for the next put
    fseek(s->f, (long)s->end, SEEK_SET);
    *out = buf;
    return it->second.len;
}

void slab_free(uint8_t* p) { free(p); }

int slab_del(void* h, const uint8_t* key, uint32_t klen) {
    Slab* s = static_cast<Slab*>(h);
    std::string k(reinterpret_cast<const char*>(key), klen);
    auto it = s->index.find(k);
    if (it == s->index.end()) return 0;
    if (fseek(s->f, (long)s->end, SEEK_SET) != 0) return -1;
    if (write_record(s->f, TAG_DEL, key, klen, nullptr, 0) != 0) return -1;
    s->dead += it->second.len;
    s->index.erase(it);
    s->end += HDR + (uint64_t)klen;
    return 0;
}

uint64_t slab_count(void* h) {
    return static_cast<Slab*>(h)->index.size();
}

uint64_t slab_dead_bytes(void* h) {
    return static_cast<Slab*>(h)->dead;
}

// Durability point: everything appended so far reaches the platter (or at
// least the drive cache barrier) before this returns 0.
int slab_flush(void* h) {
    Slab* s = static_cast<Slab*>(h);
    if (fflush(s->f) != 0) return -1;
    return fsync(fileno(s->f)) == 0 ? 0 : -1;
}

// Rewrite only the live set into a fresh log (garbage collection — the
// analog of the reference's store GC/migration passes).
int slab_compact(void* h) {
    return rewrite_live(static_cast<Slab*>(h));
}

// ---------------------------------------------------- recovery report ABI

uint64_t slab_recovery_kept(void* h) {
    return static_cast<Slab*>(h)->rec_kept;
}

uint64_t slab_recovery_dropped(void* h) {
    return static_cast<Slab*>(h)->rec_dropped;
}

uint64_t slab_recovery_truncated(void* h) {
    return static_cast<Slab*>(h)->rec_truncated;
}

// bit0: a torn/corrupt tail was truncated; bit1: v1 log migrated to v2;
// bit2: the tail was cut at a CRC mismatch (bit rot, not a torn write).
int slab_recovery_flags(void* h) {
    Slab* s = static_cast<Slab*>(h);
    return (s->tail_torn ? 1 : 0) | (s->migrated ? 2 : 0) |
           (s->crc_failed ? 4 : 0);
}

// Collect keys with a given prefix. Returns count; keys are packed as
// u32 len | bytes, into a malloc'd buffer (slab_free it).
int64_t slab_iter_prefix(void* h, const uint8_t* prefix, uint32_t plen,
                         uint8_t** out, uint64_t* out_len) {
    Slab* s = static_cast<Slab*>(h);
    std::string p(reinterpret_cast<const char*>(prefix), plen);
    std::vector<uint8_t> packed;
    int64_t n = 0;
    for (auto& [k, rec] : s->index) {
        (void)rec;
        if (k.size() >= p.size() && k.compare(0, p.size(), p) == 0) {
            uint32_t kl = (uint32_t)k.size();
            const uint8_t* klp = reinterpret_cast<const uint8_t*>(&kl);
            packed.insert(packed.end(), klp, klp + 4);
            packed.insert(packed.end(), k.begin(), k.end());
            ++n;
        }
    }
    uint8_t* buf = static_cast<uint8_t*>(malloc(packed.empty() ? 1 : packed.size()));
    memcpy(buf, packed.data(), packed.size());
    *out = buf;
    *out_len = packed.size();
    return n;
}

}  // extern "C"

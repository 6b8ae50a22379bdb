// Native host runtime of the PyTorch port (a copy of the JAX package's
// runtime/runtime.cpp; host C++, no device code).
//
// The reference's runtime layer is ROS1 C++: sensor decoding, the
// message_filters ApproximateTime synchronizer pairing /Odometry with
// /cloud_registered (fast_lio_sam_qn.cpp:75-78), and a 4-thread spinner
// moving data between callbacks (main.cpp:10).  This library provides the
// equivalents on the host side, exposed over a C ABI consumed via ctypes
// (runtime/native.py):
//
//  - fast scan decoding: KITTI velodyne .bin and PCD (ascii + binary),
//  - a multithreaded prefetching scan loader (lookahead window + worker
//    pool) so dataset IO overlaps device compute — the double-buffering
//    half of SURVEY §5's "distributed communication" replacement,
//  - an approximate-time pairing queue replacing message_filters'
//    ApproximateTime policy (greedy nearest-stamp matching within a slop,
//    monotonic, drop-unmatched — a documented simplification of the exact
//    ROS adaptive algorithm).
//
// Build: see runtime/native.py (g++ -O3 -std=c++17 -shared -fPIC -pthread,
// into build/runtime/ under a name keyed on this source and the flags).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Scan decoding
// ---------------------------------------------------------------------------

// KITTI velodyne .bin: packed float32 x,y,z,intensity records.
// Returns number of points written (<= cap), or -1 on error.
int64_t flsq_read_velodyne_bin(const char* path, float* out, int64_t cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t n = 0;
    while (n < cap) {
        size_t got = fread(out + 4 * n, sizeof(float), 4, f);
        if (got < 4) break;
        n++;
    }
    fclose(f);
    return n;
}

// PCD reader: ascii or binary, extracts x y z (+intensity if present).
// out is xyzi rows. Returns point count or -1.
int64_t flsq_read_pcd(const char* path, float* out, int64_t cap) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return -1;
    std::string line, data_mode;
    std::vector<std::string> fields;
    std::vector<int> sizes;
    std::vector<int> counts;  // PCD COUNT: elements per field (default 1)
    std::vector<char> types;
    int64_t n_points = 0;
    while (std::getline(f, line)) {
        if (!line.empty() && line[0] == '#') continue;
        std::istringstream ss(line);
        std::string key;
        ss >> key;
        if (key == "FIELDS") {
            std::string v;
            while (ss >> v) fields.push_back(v);
        } else if (key == "SIZE") {
            int v;
            while (ss >> v) sizes.push_back(v);
        } else if (key == "TYPE") {
            std::string v;
            while (ss >> v) types.push_back(v[0]);
        } else if (key == "COUNT") {
            int v;
            while (ss >> v) counts.push_back(v);
        } else if (key == "POINTS") {
            ss >> n_points;
        } else if (key == "DATA") {
            ss >> data_mode;
            break;
        }
    }
    if (fields.empty() || n_points <= 0) return -1;
    if (counts.empty()) counts.assign(fields.size(), 1);
    if (counts.size() != fields.size()) return -1;
    // only ascii and plain binary are decodable here; anything else
    // (binary_compressed, truncated header) must error, not be read as
    // raw records full of garbage
    if (data_mode != "ascii" && data_mode != "binary") return -1;
    if (data_mode == "binary" &&
        (sizes.size() != fields.size() || types.size() != fields.size()))
        return -1;
    int ix = -1, iy = -1, iz = -1, ii = -1;
    for (size_t i = 0; i < fields.size(); ++i) {
        if (fields[i] == "x") ix = (int)i;
        if (fields[i] == "y") iy = (int)i;
        if (fields[i] == "z") iz = (int)i;
        if (fields[i] == "intensity") ii = (int)i;
    }
    if (ix < 0 || iy < 0 || iz < 0) return -1;
    int64_t n = std::min<int64_t>(n_points, cap);

    // element offset of each field's FIRST element within one record
    // (COUNT>1 fields — e.g. PCL '_' padding or histograms — occupy
    // count consecutive elements; x/y/z/intensity use element 0)
    std::vector<int> eoff(fields.size());
    int total_elems = 0;
    for (size_t i = 0; i < fields.size(); ++i) {
        eoff[i] = total_elems;
        total_elems += counts[i];
    }
    if (data_mode == "ascii") {
        std::vector<double> vals(total_elems);
        for (int64_t p = 0; p < n; ++p) {
            if (!std::getline(f, line)) return p;
            std::istringstream ss(line);
            bool ok = true;
            for (int i = 0; i < total_elems; ++i)
                if (!(ss >> vals[i])) { ok = false; break; }
            // short/malformed data line: stop at the points decoded so
            // far instead of silently duplicating the previous row
            if (!ok) return p;
            out[4 * p + 0] = (float)vals[eoff[ix]];
            out[4 * p + 1] = (float)vals[eoff[iy]];
            out[4 * p + 2] = (float)vals[eoff[iz]];
            out[4 * p + 3] = ii >= 0 ? (float)vals[eoff[ii]] : 0.0f;
        }
        return n;
    }
    // binary: compute record stride and byte offsets (COUNT-aware)
    int stride = 0;
    std::vector<int> offs(fields.size());
    for (size_t i = 0; i < fields.size(); ++i) {
        offs[i] = stride;
        stride += sizes[i] * counts[i];
    }
    // consumed fields must be 4-byte floats (the memcpy below assumes
    // it); a SIZE 8 / TYPE F double cloud would otherwise yield garbage
    for (int idx : {ix, iy, iz, ii}) {
        if (idx >= 0 && (sizes[idx] != 4 || types[idx] != 'F')) return -1;
    }
    std::vector<char> rec(stride);
    for (int64_t p = 0; p < n; ++p) {
        if (!f.read(rec.data(), stride)) return p;
        float x, y, z, inten = 0.0f;
        std::memcpy(&x, rec.data() + offs[ix], 4);
        std::memcpy(&y, rec.data() + offs[iy], 4);
        std::memcpy(&z, rec.data() + offs[iz], 4);
        if (ii >= 0) std::memcpy(&inten, rec.data() + offs[ii], 4);
        out[4 * p + 0] = x;
        out[4 * p + 1] = y;
        out[4 * p + 2] = z;
        out[4 * p + 3] = inten;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Prefetching scan loader
// ---------------------------------------------------------------------------

struct Loader {
    std::vector<std::string> paths;
    int64_t cap;             // max points per scan
    int lookahead;
    std::vector<std::vector<float>> slots;   // decoded xyzi
    std::vector<int64_t> counts;             // -2 unscheduled, -3 pending
    std::vector<std::thread> workers;
    std::mutex mu;
    std::condition_variable cv_work, cv_done;
    std::deque<int> work;
    std::atomic<bool> stop{false};
    int next_schedule = 0;

    void schedule_up_to(int idx) {  // mu held
        int hi = std::min<int>((int)paths.size(), idx + lookahead + 1);
        for (; next_schedule < hi; ++next_schedule) {
            counts[next_schedule] = -3;
            work.push_back(next_schedule);
        }
        cv_work.notify_all();
    }

    void worker() {
        for (;;) {
            int idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [&] { return stop || !work.empty(); });
                if (stop) return;
                idx = work.front();
                work.pop_front();
            }
            std::vector<float> buf(4 * cap);
            const std::string& p = paths[idx];
            int64_t n;
            if (p.size() > 4 && p.substr(p.size() - 4) == ".bin") {
                n = flsq_read_velodyne_bin(p.c_str(), buf.data(), cap);
            } else {
                n = flsq_read_pcd(p.c_str(), buf.data(), cap);
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                slots[idx] = std::move(buf);
                counts[idx] = n;
            }
            cv_done.notify_all();
        }
    }
};

void* flsq_loader_create(const char** paths, int n, int64_t pts_cap,
                         int n_threads, int lookahead) {
    Loader* l = new Loader();
    l->paths.assign(paths, paths + n);
    l->cap = pts_cap;
    l->lookahead = lookahead;
    l->slots.resize(n);
    l->counts.assign(n, -2);
    {
        std::lock_guard<std::mutex> lk(l->mu);
        l->schedule_up_to(0);
    }
    for (int i = 0; i < n_threads; ++i)
        l->workers.emplace_back(&Loader::worker, l);
    return l;
}

// Blocks until scan idx decoded; copies xyzi into out; frees the slot.
// Re-reading a consumed index re-schedules a decode (slower but correct).
// Returns point count or negative error.
int64_t flsq_loader_get(void* h, int idx, float* out) {
    Loader* l = (Loader*)h;
    if (idx < 0 || idx >= (int)l->paths.size()) return -1;
    std::unique_lock<std::mutex> lk(l->mu);
    l->schedule_up_to(idx);
    if (l->counts[idx] == -4) {  // consumed earlier: decode again
        l->counts[idx] = -3;
        l->work.push_back(idx);
        l->cv_work.notify_all();
    }
    l->cv_done.wait(lk, [&] { return l->counts[idx] >= -1; });
    int64_t n = l->counts[idx];
    if (n > 0) std::memcpy(out, l->slots[idx].data(), 4 * n * sizeof(float));
    l->slots[idx].clear();
    l->slots[idx].shrink_to_fit();
    l->counts[idx] = -4;  // consumed sentinel (re-read triggers re-decode)
    return n;
}

void flsq_loader_destroy(void* h) {
    Loader* l = (Loader*)h;
    {
        std::lock_guard<std::mutex> lk(l->mu);
        l->stop = true;
    }
    l->cv_work.notify_all();
    for (auto& t : l->workers) t.join();
    delete l;
}

// ---------------------------------------------------------------------------
// Approximate-time pairing (message_filters stand-in)
// ---------------------------------------------------------------------------

struct Sync {
    double slop;
    std::deque<std::pair<double, int64_t>> qa, qb;
};

void* flsq_sync_create(double slop) {
    Sync* s = new Sync();
    s->slop = slop;
    return s;
}

void flsq_sync_push_a(void* h, double t, int64_t id) {
    ((Sync*)h)->qa.emplace_back(t, id);
}

void flsq_sync_push_b(void* h, double t, int64_t id) {
    ((Sync*)h)->qb.emplace_back(t, id);
}

// Pops the next matched pair (nearest stamps within slop, monotonic).
// Returns 1 if a pair was produced, 0 otherwise.
int flsq_sync_pop(void* h, int64_t* ida, int64_t* idb, double* ta,
                  double* tb) {
    Sync* s = (Sync*)h;
    while (!s->qa.empty() && !s->qb.empty()) {
        double t_a = s->qa.front().first;
        double t_b = s->qb.front().first;
        if (t_a < t_b - s->slop) {
            s->qa.pop_front();  // a too old to ever match
            continue;
        }
        if (t_b < t_a - s->slop) {
            s->qb.pop_front();
            continue;
        }
        // candidate pair; check whether the next b is closer to this a
        if (s->qb.size() > 1) {
            double t_b2 = s->qb[1].first;
            if (std::abs(t_b2 - t_a) < std::abs(t_b - t_a)) {
                s->qb.pop_front();
                continue;
            }
        }
        // symmetric lookahead: a later a may be closer to this b (without
        // this, the pairing quality depended on which stream was denser)
        if (s->qa.size() > 1) {
            double t_a2 = s->qa[1].first;
            if (std::abs(t_a2 - t_b) < std::abs(t_b - t_a)) {
                s->qa.pop_front();
                continue;
            }
        }
        *ta = t_a;
        *tb = t_b;
        *ida = s->qa.front().second;
        *idb = s->qb.front().second;
        s->qa.pop_front();
        s->qb.pop_front();
        return 1;
    }
    return 0;
}

void flsq_sync_destroy(void* h) { delete (Sync*)h; }

// ---------------------------------------------------------------------------
// LZ4 decompression (rosbag chunk compression=lz4 uses standard LZ4 frames;
// no lz4 library ships in this environment, so the block + frame decoders
// are implemented here). Returns decompressed size or -1 on error.
// ---------------------------------------------------------------------------

// raw LZ4 block: token -> literals -> (offset, matchlen) repeat
static int64_t lz4_block_decode(const uint8_t* src, int64_t srclen,
                                uint8_t* dst, int64_t dstcap) {
    const uint8_t* sp = src;
    const uint8_t* send = src + srclen;
    uint8_t* dp = dst;
    uint8_t* dend = dst + dstcap;
    while (sp < send) {
        uint8_t token = *sp++;
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (sp >= send) return -1;
                b = *sp++;
                litlen += b;
            } while (b == 255);
        }
        if (sp + litlen > send || dp + litlen > dend) return -1;
        std::memcpy(dp, sp, (size_t)litlen);
        sp += litlen;
        dp += litlen;
        if (sp >= send) break;  // last literals, no match
        if (sp + 2 > send) return -1;
        int64_t offset = sp[0] | (sp[1] << 8);
        sp += 2;
        if (offset == 0 || dp - dst < offset) return -1;
        int64_t mlen = (token & 0x0F);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (sp >= send) return -1;
                b = *sp++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (dp + mlen > dend) return -1;
        const uint8_t* mp = dp - offset;
        for (int64_t i = 0; i < mlen; ++i) dp[i] = mp[i];  // may overlap
        dp += mlen;
    }
    return dp - dst;
}

// LZ4 frame (magic 0x184D2204): used by rosbag lz4 chunks
int64_t flsq_lz4_decompress(const uint8_t* src, int64_t srclen,
                            uint8_t* dst, int64_t dstcap) {
    if (srclen < 7) return -1;
    uint32_t magic;
    std::memcpy(&magic, src, 4);
    if (magic != 0x184D2204u) return -1;
    const uint8_t* sp = src + 4;
    const uint8_t* send = src + srclen;
    uint8_t flg = *sp++;
    sp++;  // BD byte
    bool b_checksum = (flg >> 4) & 1;
    bool c_size = (flg >> 3) & 1;
    bool c_checksum = (flg >> 2) & 1;
    (void)c_checksum;
    if ((flg >> 6) != 1) return -1;  // version must be 01
    if (flg & 1) sp += 4;            // DictID
    if (c_size) sp += 8;
    sp++;  // header checksum
    uint8_t* dp = dst;
    for (;;) {
        if (sp + 4 > send) return -1;
        uint32_t bsz;
        std::memcpy(&bsz, sp, 4);
        sp += 4;
        if (bsz == 0) break;  // EndMark
        bool uncompressed = bsz & 0x80000000u;
        bsz &= 0x7FFFFFFFu;
        if (sp + bsz > send) return -1;
        if (uncompressed) {
            if (dp + bsz > dst + dstcap) return -1;
            std::memcpy(dp, sp, bsz);
            dp += bsz;
        } else {
            int64_t n = lz4_block_decode(sp, bsz, dp, dstcap - (dp - dst));
            if (n < 0) return -1;
            dp += n;
        }
        sp += bsz;
        if (b_checksum) sp += 4;
    }
    return dp - dst;
}

}  // extern "C"

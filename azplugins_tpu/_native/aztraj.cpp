// aztraj: native trajectory / checkpoint engine.
//
// Analog of the reference's IO stack: azplugins defers all
// trajectory/checkpoint IO to HOOMD's GSD machinery (SURVEY §5,
// "Checkpoint/resume: ... deferred to HOOMD GSD snapshots"). This is the
// from-scratch replacement: a chunked, CRC-checked, append-only binary
// container written by buffered native code so frame serialization runs
// off the Python interpreter and at disk speed. The format is original
// ("AZTJ", version 1) — not GSD byte-compatible (see DEVIATIONS.md).
//
// Layout (little-endian):
//   file header (32 B):  magic "AZTJ" | u32 version | u64 index_offset
//                        | u64 n_frames | u32 header_crc
//   frame:               u32 magic "FRAM" | u64 timestep | u32 n_chunks
//                        then per chunk:
//                          u16 name_len | name bytes
//                          u8 dtype code | u8 ndim | u64 shape[ndim]
//                          u64 nbytes | raw data | u32 crc32(data)
//   index (at EOF):      n_frames x { u64 offset, u64 timestep } | u32 crc
//
// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u32 5=u8
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kFileMagic = 0x4A545A41u;   // "AZTJ"
constexpr uint32_t kFrameMagic = 0x4D415246u;  // "FRAM"
constexpr uint32_t kVersion = 1;

// CRC-32 (IEEE 802.3, reflected), table generated at first use.
uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_ready = true;
}

uint32_t crc32(const uint8_t* data, size_t n, uint32_t seed = 0) {
    if (!crc_ready) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

struct IndexEntry {
    uint64_t offset;
    uint64_t timestep;
};

struct Writer {
    FILE* f = nullptr;
    std::vector<IndexEntry> index;
    std::string error;
};

struct Reader {
    FILE* f = nullptr;
    std::vector<IndexEntry> index;
    std::string error;
};

bool write_header(FILE* f, uint64_t index_offset, uint64_t n_frames) {
    uint8_t buf[32];
    std::memset(buf, 0, sizeof(buf));
    std::memcpy(buf, &kFileMagic, 4);
    std::memcpy(buf + 4, &kVersion, 4);
    std::memcpy(buf + 8, &index_offset, 8);
    std::memcpy(buf + 16, &n_frames, 8);
    uint32_t crc = crc32(buf, 24);
    std::memcpy(buf + 24, &crc, 4);
    if (std::fseek(f, 0, SEEK_SET) != 0) return false;
    return std::fwrite(buf, 1, sizeof(buf), f) == sizeof(buf);
}

bool read_header(FILE* f, uint64_t* index_offset, uint64_t* n_frames) {
    uint8_t buf[32];
    if (std::fseek(f, 0, SEEK_SET) != 0) return false;
    if (std::fread(buf, 1, sizeof(buf), f) != sizeof(buf)) return false;
    uint32_t magic, version, crc_stored;
    std::memcpy(&magic, buf, 4);
    std::memcpy(&version, buf + 4, 4);
    std::memcpy(index_offset, buf + 8, 8);
    std::memcpy(n_frames, buf + 16, 8);
    std::memcpy(&crc_stored, buf + 24, 4);
    if (magic != kFileMagic || version != kVersion) return false;
    return crc32(buf, 24) == crc_stored;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer --
void* azt_open_write(const char* path, int append) {
    Writer* w = new Writer();
    if (append) {
        // load the existing index, truncate it away, continue appending
        FILE* f = std::fopen(path, "r+b");
        if (f) {
            uint64_t idx_off = 0, n_frames = 0;
            if (read_header(f, &idx_off, &n_frames) && idx_off > 0) {
                std::fseek(f, (long)idx_off, SEEK_SET);
                w->index.resize(n_frames);
                if (n_frames && std::fread(w->index.data(), sizeof(IndexEntry),
                                           n_frames, f) != n_frames) {
                    w->index.clear();
                }
                std::fseek(f, (long)idx_off, SEEK_SET);
                w->f = f;
                return w;
            }
            std::fclose(f);
        }
    }
    w->f = std::fopen(path, "w+b");
    if (!w->f) {
        delete w;
        return nullptr;
    }
    write_header(w->f, 0, 0);
    return w;
}

// names: n_chunks C strings; dtypes/ndims per chunk; shapes: flattened
// (sum of ndims) u64s; data: per-chunk raw pointers; nbytes per chunk.
int azt_write_frame(void* handle, uint64_t timestep, int n_chunks,
                    const char** names, const uint8_t* dtypes,
                    const uint8_t* ndims, const uint64_t* shapes,
                    const void** data, const uint64_t* nbytes) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w || !w->f) return -1;
    long pos = std::ftell(w->f);
    if (pos < 0) return -2;
    w->index.push_back({(uint64_t)pos, timestep});

    uint32_t nc = (uint32_t)n_chunks;
    if (std::fwrite(&kFrameMagic, 4, 1, w->f) != 1) return -3;
    if (std::fwrite(&timestep, 8, 1, w->f) != 1) return -3;
    if (std::fwrite(&nc, 4, 1, w->f) != 1) return -3;

    size_t shape_pos = 0;
    for (int c = 0; c < n_chunks; ++c) {
        uint16_t name_len = (uint16_t)std::strlen(names[c]);
        if (std::fwrite(&name_len, 2, 1, w->f) != 1) return -3;
        if (std::fwrite(names[c], 1, name_len, w->f) != name_len) return -3;
        if (std::fwrite(&dtypes[c], 1, 1, w->f) != 1) return -3;
        if (std::fwrite(&ndims[c], 1, 1, w->f) != 1) return -3;
        for (int d = 0; d < ndims[c]; ++d) {
            if (std::fwrite(&shapes[shape_pos + d], 8, 1, w->f) != 1) return -3;
        }
        shape_pos += ndims[c];
        if (std::fwrite(&nbytes[c], 8, 1, w->f) != 1) return -3;
        if (nbytes[c] &&
            std::fwrite(data[c], 1, nbytes[c], w->f) != nbytes[c]) return -3;
        uint32_t crc = crc32((const uint8_t*)data[c], nbytes[c]);
        if (std::fwrite(&crc, 4, 1, w->f) != 1) return -3;
    }
    return 0;
}

int azt_flush(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w || !w->f) return -1;
    // persist the current index + header so readers see a valid file even
    // before close (crash consistency: index is rewritten on next append)
    long pos = std::ftell(w->f);
    if (pos < 0) return -2;
    uint64_t n = w->index.size();
    if (n && std::fwrite(w->index.data(), sizeof(IndexEntry), n, w->f) != n)
        return -3;
    uint32_t crc = crc32((const uint8_t*)w->index.data(), n * sizeof(IndexEntry));
    if (std::fwrite(&crc, 4, 1, w->f) != 1) return -3;
    if (!write_header(w->f, (uint64_t)pos, n)) return -3;
    if (std::fseek(w->f, pos, SEEK_SET) != 0) return -2;
    std::fflush(w->f);
    return 0;
}

int azt_close_write(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w) return -1;
    int rc = azt_flush(handle);
    if (w->f) std::fclose(w->f);
    delete w;
    return rc;
}

// ---------------------------------------------------------------- reader --
void* azt_open_read(const char* path) {
    Reader* r = new Reader();
    r->f = std::fopen(path, "rb");
    if (!r->f) {
        delete r;
        return nullptr;
    }
    uint64_t idx_off = 0, n_frames = 0;
    if (!read_header(r->f, &idx_off, &n_frames) || idx_off == 0) {
        std::fclose(r->f);
        delete r;
        return nullptr;
    }
    r->index.resize(n_frames);
    std::fseek(r->f, (long)idx_off, SEEK_SET);
    if (n_frames && std::fread(r->index.data(), sizeof(IndexEntry), n_frames,
                               r->f) != n_frames) {
        std::fclose(r->f);
        delete r;
        return nullptr;
    }
    std::vector<uint8_t> raw(n_frames * sizeof(IndexEntry));
    std::memcpy(raw.data(), r->index.data(), raw.size());
    uint32_t crc_stored, crc = crc32(raw.data(), raw.size());
    if (std::fread(&crc_stored, 4, 1, r->f) != 1 || crc_stored != crc) {
        std::fclose(r->f);
        delete r;
        return nullptr;
    }
    return r;
}

int64_t azt_n_frames(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    return r ? (int64_t)r->index.size() : -1;
}

int64_t azt_frame_timestep(void* handle, int64_t i) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r || i < 0 || (size_t)i >= r->index.size()) return -1;
    return (int64_t)r->index[i].timestep;
}

// Two-phase read: first query the frame's layout, then fill caller buffers.
// Phase 1 (query): returns n_chunks; fills names_buf (nul-separated),
// dtypes, ndims, shapes (flattened), nbytes if non-null.
int azt_frame_info(void* handle, int64_t i, char* names_buf,
                   int names_buf_len, uint8_t* dtypes, uint8_t* ndims,
                   uint64_t* shapes, uint64_t* nbytes) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r || i < 0 || (size_t)i >= r->index.size()) return -1;
    std::fseek(r->f, (long)r->index[i].offset, SEEK_SET);
    uint32_t magic, nc;
    uint64_t ts;
    if (std::fread(&magic, 4, 1, r->f) != 1 || magic != kFrameMagic) return -2;
    if (std::fread(&ts, 8, 1, r->f) != 1) return -2;
    if (std::fread(&nc, 4, 1, r->f) != 1) return -2;
    int name_pos = 0;
    size_t shape_pos = 0;
    for (uint32_t c = 0; c < nc; ++c) {
        uint16_t nl;
        if (std::fread(&nl, 2, 1, r->f) != 1) return -2;
        char name[256];
        if (nl >= sizeof(name)) return -2;
        if (std::fread(name, 1, nl, r->f) != nl) return -2;
        name[nl] = 0;
        if (names_buf) {
            if (name_pos + nl + 1 > names_buf_len) return -3;
            std::memcpy(names_buf + name_pos, name, nl + 1);
        }
        name_pos += nl + 1;
        uint8_t dt, nd;
        if (std::fread(&dt, 1, 1, r->f) != 1) return -2;
        if (std::fread(&nd, 1, 1, r->f) != 1) return -2;
        if (dtypes) dtypes[c] = dt;
        if (ndims) ndims[c] = nd;
        for (int d = 0; d < nd; ++d) {
            uint64_t s;
            if (std::fread(&s, 8, 1, r->f) != 1) return -2;
            if (shapes) shapes[shape_pos + d] = s;
        }
        shape_pos += nd;
        uint64_t nb;
        if (std::fread(&nb, 8, 1, r->f) != 1) return -2;
        if (nbytes) nbytes[c] = nb;
        std::fseek(r->f, (long)(nb + 4), SEEK_CUR);  // skip data + crc
    }
    return (int)nc;
}

// Phase 2: read chunk `c` of frame `i` into out (must be nbytes long).
// Returns 0 on success, -4 on CRC mismatch.
int azt_read_chunk(void* handle, int64_t i, int chunk, void* out) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r || i < 0 || (size_t)i >= r->index.size()) return -1;
    std::fseek(r->f, (long)r->index[i].offset, SEEK_SET);
    uint32_t magic, nc;
    uint64_t ts;
    if (std::fread(&magic, 4, 1, r->f) != 1 || magic != kFrameMagic) return -2;
    if (std::fread(&ts, 8, 1, r->f) != 1) return -2;
    if (std::fread(&nc, 4, 1, r->f) != 1) return -2;
    if (chunk < 0 || (uint32_t)chunk >= nc) return -1;
    for (uint32_t c = 0; c < nc; ++c) {
        uint16_t nl;
        if (std::fread(&nl, 2, 1, r->f) != 1) return -2;
        std::fseek(r->f, nl, SEEK_CUR);
        uint8_t dt, nd;
        if (std::fread(&dt, 1, 1, r->f) != 1) return -2;
        if (std::fread(&nd, 1, 1, r->f) != 1) return -2;
        std::fseek(r->f, 8 * nd, SEEK_CUR);
        uint64_t nb;
        if (std::fread(&nb, 8, 1, r->f) != 1) return -2;
        if ((uint32_t)c == (uint32_t)chunk) {
            if (nb && std::fread(out, 1, nb, r->f) != nb) return -2;
            uint32_t crc_stored;
            if (std::fread(&crc_stored, 4, 1, r->f) != 1) return -2;
            if (crc32((const uint8_t*)out, nb) != crc_stored) return -4;
            return 0;
        }
        std::fseek(r->f, (long)(nb + 4), SEEK_CUR);
    }
    return -1;
}

int azt_close_read(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r) return -1;
    if (r->f) std::fclose(r->f);
    delete r;
    return 0;
}

}  // extern "C"

// Native host decode library: CAF container parsing, IMA4 ADPCM / LPCM
// decoding, and polyphase rational resampling.
//
// This is the framework's native runtime component, replacing the reference's
// reliance on Apple AudioToolbox (ExtAudioFileOpenURL/Read + implicit SRC,
// LBAudioDetective.m:224-288).  Exposed as a C ABI consumed via ctypes
// (lbaudiodetective_torch/io/native/binding.py); semantics match the NumPy
// fallback in io/caf.py and io/resample.py (validated by
// tests/test_native_decoder.py).
//
// Build: make -C lbaudiodetective_torch/io/native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint16_t be16(const uint8_t* p) {
    return static_cast<uint16_t>((p[0] << 8) | p[1]);
}
inline uint32_t be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
inline uint64_t be64(const uint8_t* p) {
    return (static_cast<uint64_t>(be32(p)) << 32) | be32(p + 4);
}
inline double be_f64(const uint8_t* p) {
    uint64_t bits = be64(p);
    double d;
    std::memcpy(&d, &bits, 8);
    return d;
}

const int kIndexTable[16] = {-1, -1, -1, -1, 2, 4, 6, 8,
                             -1, -1, -1, -1, 2, 4, 6, 8};
const int kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767};

inline int clamp(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Decode mono Apple IMA4: 34-byte packets = 2-byte BE state header + 32
// nibble bytes, low nibble first (see io/caf.py decode_ima4).
void decode_ima4(const uint8_t* data, size_t size, int64_t valid_frames,
                 std::vector<float>* out) {
    const size_t packets = size / 34;
    out->reserve(packets * 64);
    for (size_t pk = 0; pk < packets; ++pk) {
        const uint8_t* p = data + pk * 34;
        uint16_t header = be16(p);
        int predictor = static_cast<int16_t>(header & 0xFF80);
        int index = clamp(header & 0x7F, 0, 88);
        for (int i = 0; i < 32; ++i) {
            uint8_t byte = p[2 + i];
            for (int half = 0; half < 2; ++half) {
                int nib = half ? (byte >> 4) : (byte & 0x0F);
                int step = kStepTable[index];
                int diff = step >> 3;
                if (nib & 1) diff += step >> 2;
                if (nib & 2) diff += step >> 1;
                if (nib & 4) diff += step;
                if (nib & 8) diff = -diff;
                predictor = clamp(predictor + diff, -32768, 32767);
                index = clamp(index + kIndexTable[nib], 0, 88);
                out->push_back(static_cast<float>(predictor) / 32768.0f);
            }
        }
    }
    if (valid_frames >= 0 && static_cast<size_t>(valid_frames) < out->size())
        out->resize(static_cast<size_t>(valid_frames));
}

// ITU-T G.711 expansion (same scalar formulas as io/g711.py; the NumPy
// path builds its 256-entry tables from them, so the two paths agree
// bit-exactly).
inline int mulaw_expand(uint8_t u8) {
    int u = ~u8 & 0xFF;
    int sign = u & 0x80;
    int exponent = (u >> 4) & 0x07;
    int mantissa = u & 0x0F;
    int t = (((mantissa << 3) + 0x84) << exponent) - 0x84;
    return sign ? -t : t;
}
inline int alaw_expand(uint8_t a8) {
    int a = a8 ^ 0x55;
    int sign = a & 0x80;
    int seg = (a >> 4) & 0x07;
    int t = (a & 0x0F) << 4;
    if (seg == 0) t += 8;
    else if (seg == 1) t += 0x108;
    else t = (t + 0x108) << (seg - 1);
    return sign ? t : -t;
}

void decode_g711(const uint8_t* data, size_t size, bool mulaw,
                 uint32_t channels, int64_t valid_frames,
                 std::vector<float>* out) {
    const size_t frames = size / channels;
    out->resize(frames);
    for (size_t f = 0; f < frames; ++f) {
        double acc = 0.0;
        for (uint32_t ch = 0; ch < channels; ++ch) {
            uint8_t b = data[f * channels + ch];
            acc += (mulaw ? mulaw_expand(b) : alaw_expand(b)) / 32768.0;
        }
        (*out)[f] = static_cast<float>(acc / channels);
    }
    if (valid_frames >= 0 && static_cast<size_t>(valid_frames) < out->size())
        out->resize(static_cast<size_t>(valid_frames));
}

void decode_lpcm(const uint8_t* data, size_t size, uint32_t flags,
                 uint32_t bits, uint32_t channels, std::vector<float>* out) {
    const bool is_float = flags & 1;
    const bool little = flags & 2;
    const size_t bytes = bits / 8;
    // Callers validate channels/bits, but a divide-by-zero here is fatal to
    // the whole process (SIGFPE), so guard defensively as well.
    if (bytes == 0 || channels == 0) {
        out->clear();
        return;
    }
    const size_t frames = size / (bytes * channels);
    out->resize(frames);
    for (size_t f = 0; f < frames; ++f) {
        double acc = 0.0;
        for (uint32_t ch = 0; ch < channels; ++ch) {
            const uint8_t* p = data + (f * channels + ch) * bytes;
            uint8_t buf[8];
            if (little) {
                std::memcpy(buf, p, bytes);
            } else {
                for (size_t i = 0; i < bytes; ++i) buf[i] = p[bytes - 1 - i];
            }
            double v = 0.0;
            if (is_float && bits == 32) {
                float x;
                std::memcpy(&x, buf, 4);
                v = x;
            } else if (is_float && bits == 64) {
                double x;
                std::memcpy(&x, buf, 8);
                v = x;
            } else if (bits == 8) {
                v = static_cast<int8_t>(buf[0]) / 128.0;
            } else if (bits == 16) {
                int16_t x;
                std::memcpy(&x, buf, 2);
                v = x / 32768.0;
            } else if (bits == 24) {
                int32_t x = buf[0] | (buf[1] << 8) | (buf[2] << 16);
                if (x >= (1 << 23)) x -= (1 << 24);
                v = x / 8388608.0;
            } else if (bits == 32) {
                int32_t x;
                std::memcpy(&x, buf, 4);
                v = x / 2147483648.0;
            }
            acc += v;
        }
        (*out)[f] = static_cast<float>(acc / channels);
    }
}

inline uint16_t le16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t le32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (p[1] << 8) | (p[2] << 16)
           | (static_cast<uint32_t>(p[3]) << 24);
}

// IEEE 754 80-bit extended float (the AIFF COMM sampleRate field); mirrors
// io/aiff.py::_read_extended80.
inline double ext80(const uint8_t* p) {
    uint16_t se = be16(p);
    uint64_t mant = be64(p + 2);
    double sign = (se & 0x8000) ? -1.0 : 1.0;
    int exp = se & 0x7FFF;
    if (exp == 0 && mant == 0) return 0.0;
    if (exp == 0x7FFF) return 0.0;  // non-finite: caller rejects rate 0
    return sign * static_cast<double>(mant)
           * std::pow(2.0, exp - 16383 - 63);
}

// RIFF/WAVE: integer PCM 16/24/32, float32/64, G.711 (tags 6/7), incl.
// WAVE_FORMAT_EXTENSIBLE subformats; mirrors io/wav.py::read_wav.  ADPCM
// (tags 2/0x11) returns nonzero so the caller falls back to NumPy.
int read_wav_buffer(const std::vector<uint8_t>& raw,
                    std::vector<float>* samples, double* out_rate) {
    const size_t n = raw.size();
    if (n < 12 || std::memcmp(raw.data(), "RIFF", 4) != 0
        || std::memcmp(raw.data() + 8, "WAVE", 4) != 0)
        return 3;
    size_t off = 12;
    bool have_fmt = false;
    uint32_t audio_format = 0, channels = 0, rate = 0, bits = 0;
    const uint8_t* fmt_payload = nullptr;
    size_t fmt_size = 0;
    const uint8_t* data = nullptr;
    size_t data_size = 0;
    while (off + 8 <= n) {
        const uint8_t* hdr = raw.data() + off;
        size_t csize = le32(hdr + 4);
        size_t payload = off + 8;
        if (payload + csize > n) csize = n - payload;  // tolerate truncation
        if (std::memcmp(hdr, "fmt ", 4) == 0) {
            if (csize < 16) return 4;
            fmt_payload = raw.data() + payload;
            fmt_size = csize;
            audio_format = le16(fmt_payload);
            channels = le16(fmt_payload + 2);
            rate = le32(fmt_payload + 4);
            bits = le16(fmt_payload + 14);
            have_fmt = true;
        } else if (std::memcmp(hdr, "data", 4) == 0) {
            data = raw.data() + payload;
            data_size = csize;
        }
        off = payload + csize + (csize & 1);           // word-aligned chunks
    }
    if (!have_fmt || !data || rate == 0) return 4;
    if (audio_format == 0xFFFE) {                       // EXTENSIBLE
        if (fmt_size < 26) return 6;
        audio_format = le16(fmt_payload + 24);          // SubFormat GUID tag
    }
    if (channels < 1) return 4;
    *out_rate = static_cast<double>(rate);
    if (audio_format == 1) {                            // integer PCM
        if (bits != 16 && bits != 24 && bits != 32) return 6;
        decode_lpcm(data, data_size, /*flags=*/2u, bits, channels, samples);
    } else if (audio_format == 3) {                     // IEEE float
        if (bits != 32 && bits != 64) return 6;
        decode_lpcm(data, data_size, /*flags=*/3u, bits, channels, samples);
    } else if (audio_format == 6 || audio_format == 7) {  // G.711
        decode_g711(data, data_size, audio_format == 7, channels, -1, samples);
    } else {
        return 6;  // ADPCM etc.: NumPy fallback decodes (or raises typed)
    }
    return 0;
}

// AIFF/AIFF-C: big-endian PCM 8/16/24/32, 'sowt', fl32/fl64, ulaw/alaw;
// mirrors io/aiff.py::read_aiff.
int read_aiff_buffer(const std::vector<uint8_t>& raw,
                     std::vector<float>* samples, double* out_rate) {
    const size_t n = raw.size();
    if (n < 12 || std::memcmp(raw.data(), "FORM", 4) != 0) return 3;
    const bool is_aifc = std::memcmp(raw.data() + 8, "AIFC", 4) == 0;
    if (!is_aifc && std::memcmp(raw.data() + 8, "AIFF", 4) != 0) return 3;
    size_t off = 12;
    bool have_comm = false;
    uint32_t channels = 0, frames = 0, bits = 0;
    double rate = 0.0;
    char comp[5] = {'N', 'O', 'N', 'E', 0};
    const uint8_t* ssnd = nullptr;
    size_t ssnd_size = 0;
    while (off + 8 <= n) {
        const uint8_t* hdr = raw.data() + off;
        size_t csize = be32(hdr + 4);
        size_t payload = off + 8;
        if (payload + csize > n) csize = n - payload;
        if (std::memcmp(hdr, "COMM", 4) == 0) {
            if (csize < 18) return 4;
            channels = be16(raw.data() + payload);
            frames = be32(raw.data() + payload + 2);
            bits = be16(raw.data() + payload + 6);
            rate = ext80(raw.data() + payload + 8);
            have_comm = true;
            if (is_aifc && csize >= 22)
                std::memcpy(comp, raw.data() + payload + 18, 4);
        } else if (std::memcmp(hdr, "SSND", 4) == 0) {
            if (csize < 8) return 4;
            size_t data_off = be32(raw.data() + payload);
            if (8 + data_off <= csize) {
                ssnd = raw.data() + payload + 8 + data_off;
                ssnd_size = csize - 8 - data_off;
            }
        }
        off = payload + csize + (csize & 1);
    }
    if (!have_comm || !ssnd || channels < 1 || !(rate > 0.0) || rate >= 1e7)
        return 4;
    *out_rate = rate;
    const bool sowt = std::memcmp(comp, "sowt", 4) == 0;
    if (std::memcmp(comp, "NONE", 4) == 0 || sowt) {
        if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return 6;
        decode_lpcm(ssnd, ssnd_size, sowt ? 2u : 0u, bits, channels, samples);
    } else if (std::memcmp(comp, "fl32", 4) == 0
               || std::memcmp(comp, "FL32", 4) == 0) {
        decode_lpcm(ssnd, ssnd_size, 1u, 32, channels, samples);
    } else if (std::memcmp(comp, "fl64", 4) == 0
               || std::memcmp(comp, "FL64", 4) == 0) {
        decode_lpcm(ssnd, ssnd_size, 1u, 64, channels, samples);
    } else if (std::memcmp(comp, "ulaw", 4) == 0
               || std::memcmp(comp, "ULAW", 4) == 0
               || std::memcmp(comp, "alaw", 4) == 0
               || std::memcmp(comp, "ALAW", 4) == 0) {
        decode_g711(ssnd, ssnd_size, comp[0] == 'u' || comp[0] == 'U',
                    channels, -1, samples);
    } else {
        return 6;
    }
    if (frames > 0 && samples->size() > frames) samples->resize(frames);
    return 0;
}

// Sun/NeXT AU: PCM 8/16/24/32 BE, float32/64 BE, G.711; mirrors
// io/au.py::read_au.
int read_au_buffer(const std::vector<uint8_t>& raw,
                   std::vector<float>* samples, double* out_rate) {
    const size_t n = raw.size();
    if (n < 24 || std::memcmp(raw.data(), ".snd", 4) != 0) return 3;
    uint32_t data_off = be32(raw.data() + 4);
    uint32_t data_size = be32(raw.data() + 8);
    uint32_t enc = be32(raw.data() + 12);
    uint32_t rate = be32(raw.data() + 16);
    uint32_t channels = be32(raw.data() + 20);
    if (data_off < 24 || data_off > n || channels < 1 || rate == 0
        || rate >= 10000000u)
        return 4;
    const uint8_t* data = raw.data() + data_off;
    size_t avail = n - data_off;
    if (data_size != 0xFFFFFFFFu && data_size < avail) avail = data_size;
    *out_rate = static_cast<double>(rate);
    switch (enc) {
        case 1: decode_g711(data, avail, true, channels, -1, samples); break;
        case 27: decode_g711(data, avail, false, channels, -1, samples); break;
        case 2: decode_lpcm(data, avail, 0u, 8, channels, samples); break;
        case 3: decode_lpcm(data, avail, 0u, 16, channels, samples); break;
        case 4: decode_lpcm(data, avail, 0u, 24, channels, samples); break;
        case 5: decode_lpcm(data, avail, 0u, 32, channels, samples); break;
        case 6: decode_lpcm(data, avail, 1u, 32, channels, samples); break;
        case 7: decode_lpcm(data, avail, 1u, 64, channels, samples); break;
        default: return 6;
    }
    return 0;
}

int read_caf_buffer(const std::vector<uint8_t>& raw,
                    std::vector<float>* out, double* out_rate);

int read_file_bytes(const char* path, std::vector<uint8_t>* raw) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long fsize = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    raw->resize(static_cast<size_t>(fsize));
    if (std::fread(raw->data(), 1, raw->size(), f) != raw->size()) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    return 0;
}

int emit(const std::vector<float>& samples, double rate,
         float** out_samples, int64_t* out_n, double* out_rate) {
    *out_n = static_cast<int64_t>(samples.size());
    *out_samples =
        static_cast<float*>(std::malloc(samples.size() * sizeof(float)));
    if (!*out_samples) return 7;
    std::memcpy(*out_samples, samples.data(), samples.size() * sizeof(float));
    *out_rate = rate;
    return 0;
}

int read_caf_buffer(const std::vector<uint8_t>& raw,
                    std::vector<float>* out, double* out_rate) {
    if (raw.size() < 8 || std::memcmp(raw.data(), "caff", 4) != 0) return 3;

    double rate = 0.0;
    char fmt[5] = {0};
    uint32_t flags = 0, bits = 0, channels = 1;
    int64_t valid_frames = -1;
    const uint8_t* data_chunk = nullptr;
    size_t data_size = 0;

    size_t off = 8;
    while (off + 12 <= raw.size()) {
        const uint8_t* hdr = raw.data() + off;
        int64_t csize = static_cast<int64_t>(be64(hdr + 4));
        size_t payload = off + 12;
        if (csize < 0) csize = static_cast<int64_t>(raw.size() - payload);
        // Clamp truncated chunks to the bytes actually present (a cut file
        // must decode its surviving prefix, not read past the buffer).
        if (payload + static_cast<size_t>(csize) > raw.size())
            csize = static_cast<int64_t>(raw.size() - payload);
        if (std::memcmp(hdr, "desc", 4) == 0 && payload + 32 <= raw.size()) {
            rate = be_f64(raw.data() + payload);
            std::memcpy(fmt, raw.data() + payload + 8, 4);
            flags = be32(raw.data() + payload + 12);
            channels = be32(raw.data() + payload + 24);
            bits = be32(raw.data() + payload + 28);
        } else if (std::memcmp(hdr, "pakt", 4) == 0 && payload + 24 <= raw.size()) {
            valid_frames = static_cast<int64_t>(be64(raw.data() + payload + 8));
        } else if (std::memcmp(hdr, "data", 4) == 0 && csize > 4) {
            data_chunk = raw.data() + payload + 4;  // skip edit count
            data_size = static_cast<size_t>(csize) - 4;
        }
        off = payload + static_cast<size_t>(csize);
    }
    if (!data_chunk || rate == 0.0) return 4;

    std::vector<float> samples;
    if (std::strcmp(fmt, "ima4") == 0) {
        if (channels != 1) return 5;
        decode_ima4(data_chunk, data_size, valid_frames, &samples);
    } else if (std::strcmp(fmt, "lpcm") == 0) {
        // File-controlled channels/bits must be validated before they reach
        // decode_lpcm's frame arithmetic (channels=0 or bits<8 would
        // integer-divide by zero -> SIGFPE killing the serving process).
        if (channels < 1) return 5;
        const bool is_float = flags & 1;
        if (is_float ? (bits != 32 && bits != 64)
                     : (bits != 8 && bits != 16 && bits != 24 && bits != 32))
            return 6;
        decode_lpcm(data_chunk, data_size, flags, bits, channels, &samples);
    } else if (std::strcmp(fmt, "ulaw") == 0 || std::strcmp(fmt, "alaw") == 0) {
        if (channels < 1) return 5;
        decode_g711(data_chunk, data_size, fmt[0] == 'u', channels,
                    valid_frames, &samples);
    } else {
        return 6;
    }

    *out = std::move(samples);
    *out_rate = rate;
    return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success.  *out_samples is malloc'd; free with lbad_free.
int lbad_read_caf(const char* path, float** out_samples, int64_t* out_n,
                  double* out_rate) {
    std::vector<uint8_t> raw;
    int rc = read_file_bytes(path, &raw);
    if (rc) return rc;
    std::vector<float> samples;
    double rate = 0.0;
    rc = read_caf_buffer(raw, &samples, &rate);
    if (rc) return rc;
    return emit(samples, rate, out_samples, out_n, out_rate);
}

// Container-dispatching entry: CAF, WAV, AIFF/AIFF-C, AU/SND by magic.
// Nonzero statuses (unknown magic, unsupported codec, malformed header)
// signal the Python binding to fall back to the NumPy readers, which are
// the behavioural source of truth for error reporting.
int lbad_read_audio(const char* path, float** out_samples, int64_t* out_n,
                    double* out_rate) {
    std::vector<uint8_t> raw;
    int rc = read_file_bytes(path, &raw);
    if (rc) return rc;
    if (raw.size() < 4) return 3;
    std::vector<float> samples;
    double rate = 0.0;
    if (std::memcmp(raw.data(), "caff", 4) == 0)
        rc = read_caf_buffer(raw, &samples, &rate);
    else if (std::memcmp(raw.data(), "RIFF", 4) == 0)
        rc = read_wav_buffer(raw, &samples, &rate);
    else if (std::memcmp(raw.data(), "FORM", 4) == 0)
        rc = read_aiff_buffer(raw, &samples, &rate);
    else if (std::memcmp(raw.data(), ".snd", 4) == 0)
        rc = read_au_buffer(raw, &samples, &rate);
    else
        return 3;
    if (rc) return rc;
    return emit(samples, rate, out_samples, out_n, out_rate);
}

// Polyphase rational resampling with a caller-provided filter bank
// [up, taps] (same plan arithmetic as io/resample.py: output n reads padded
// input at base = floor(n*down/up) - (taps/2 - 1), phase = (n*down) % up).
int lbad_resample(const float* x, int64_t n_in, const float* bank,
                  int64_t up, int64_t down, int64_t taps, float* out,
                  int64_t n_out) {
    std::vector<float> padded(static_cast<size_t>(n_in) + 2 * taps, 0.0f);
    std::memcpy(padded.data() + taps, x, static_cast<size_t>(n_in) * sizeof(float));
    const int64_t half = taps / 2;
    for (int64_t n = 0; n < n_out; ++n) {
        const int64_t num = n * down;
        const int64_t i0 = num / up;
        const int64_t phase = num - i0 * up;
        const float* w = bank + phase * taps;
        const float* src = padded.data() + (i0 - (half - 1)) + taps;
        // Pairwise-ish accumulation in double keeps parity with NumPy einsum
        // within float32 rounding.
        double acc = 0.0;
        for (int64_t t = 0; t < taps; ++t) acc += static_cast<double>(src[t]) * w[t];
        out[n] = static_cast<float>(acc);
    }
    return 0;
}

void lbad_free(float* p) { std::free(p); }
}

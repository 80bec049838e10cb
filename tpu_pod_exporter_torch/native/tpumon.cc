// libtpumon — native helpers for tpu-pod-exporter.
//
// TPU-native analog of the reference's single native component (the NVML C
// library reached via cgo, reference main.go:16,44-54,116-138; SURVEY.md
// §2.7 "native-component ledger"). Two jobs:
//
//   1. Device discovery: scan /dev for accel*/vfio nodes without opening
//      them (no runtime lock, no ioctls).
//   2. Exposition rendering: format `prefix value\n` lines for thousands of
//      series per poll. Called once per poll, never per scrape — but at a
//      1 s interval × 256 chips × ~10 series × 7 links this is the hottest
//      CPU in the process, and the <1% node CPU budget is the point.
//
// Pure C ABI (loaded via ctypes — no pybind11 in the image); every function
// is safe to call from any thread; no global state.

#include <cstdio>
#include <cstring>
#include <cstdint>
#include <cstdlib>
#include <cmath>

#include <dirent.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

bool is_all_digits(const char* s) {
  if (!*s) return false;
  for (; *s; ++s)
    if (*s < '0' || *s > '9') return false;
  return true;
}

// Scan root/dev for TPU device nodes. Returns count; if out != null, writes
// newline-separated "/dev/<name>" paths (relative to root) up to cap bytes.
int scan_devices(const char* root, char* out, long cap) {
  char dev_path[4096];
  std::snprintf(dev_path, sizeof(dev_path), "%s/dev", root ? root : "/");

  int count = 0;
  long used = 0;

  DIR* d = opendir(dev_path);
  if (d != nullptr) {
    struct dirent* e;
    while ((e = readdir(d)) != nullptr) {
      if (std::strncmp(e->d_name, "accel", 5) == 0 && is_all_digits(e->d_name + 5)) {
        ++count;
        if (out != nullptr) {
          int n = std::snprintf(out + used, cap > used ? cap - used : 0,
                                "/dev/%s\n", e->d_name);
          if (n > 0 && used + n < cap) used += n;
        }
      }
    }
    closedir(d);
  }

  if (count == 0) {
    // vfio fallback (v6e+): /dev/vfio/<N> numeric nodes.
    char vfio_path[4096];
    std::snprintf(vfio_path, sizeof(vfio_path), "%s/dev/vfio", root ? root : "/");
    DIR* v = opendir(vfio_path);
    if (v != nullptr) {
      struct dirent* e;
      while ((e = readdir(v)) != nullptr) {
        if (is_all_digits(e->d_name)) {
          ++count;
          if (out != nullptr) {
            int n = std::snprintf(out + used, cap > used ? cap - used : 0,
                                  "/dev/vfio/%s\n", e->d_name);
            if (n > 0 && used + n < cap) used += n;
          }
        }
      }
      closedir(v);
    }
  }

  if (count == 0) {
    // Last resort: sysfs accel class (pods with /sys but no raw /dev nodes).
    char sys_path[4096];
    std::snprintf(sys_path, sizeof(sys_path), "%s/sys/class/accel",
                  root ? root : "/");
    DIR* s = opendir(sys_path);
    if (s != nullptr) {
      struct dirent* e;
      while ((e = readdir(s)) != nullptr) {
        if (std::strncmp(e->d_name, "accel", 5) == 0 && is_all_digits(e->d_name + 5)) {
          ++count;
          if (out != nullptr) {
            int n = std::snprintf(out + used, cap > used ? cap - used : 0,
                                  "/dev/%s\n", e->d_name);
            if (n > 0 && used + n < cap) used += n;
          }
        }
      }
      closedir(s);
    }
  }

  if (out != nullptr && cap > 0) out[used < cap ? used : cap - 1] = '\0';
  return count;
}

// Two-digit lookup table for the integer fast path — snprintf("%lld") costs
// ~100-200 ns per call, and at 256 chips × ~16 series × 1 s nearly every
// sample value is integral (bytes, counters, rounded rates).
const char kDigits[201] =
    "0001020304050607080910111213141516171819"
    "2021222324252627282930313233343536373839"
    "4041424344454647484950515253545556575859"
    "6061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

inline int format_ll(long long v, char* out) {
  char tmp[24];
  int n = 0;
  bool neg = v < 0;
  unsigned long long u = neg ? 0ULL - (unsigned long long)v : (unsigned long long)v;
  while (u >= 100) {
    unsigned r = (unsigned)(u % 100);
    u /= 100;
    tmp[n++] = kDigits[r * 2 + 1];
    tmp[n++] = kDigits[r * 2];
  }
  if (u >= 10) {
    tmp[n++] = kDigits[u * 2 + 1];
    tmp[n++] = kDigits[u * 2];
  } else {
    tmp[n++] = (char)('0' + u);
  }
  int len = 0;
  if (neg) out[len++] = '-';
  while (n > 0) out[len++] = tmp[--n];
  return len;
}

// Format one sample value, Prometheus-style. Matches the Python encoder's
// contract (integral values without exponent/decimal, shortest-round-trip
// otherwise, NaN/+Inf/-Inf spelled out).
inline int format_value(double v, char* out, int cap) {
  if (std::isnan(v)) return std::snprintf(out, cap, "NaN");
  if (std::isinf(v)) return std::snprintf(out, cap, v > 0 ? "+Inf" : "-Inf");
  if (v == std::floor(v) && std::fabs(v) < 9007199254740992.0 /* 2^53 */) {
    return format_ll((long long)v, out);
  }
  // %.17g always round-trips; try %.15g / %.16g first for shorter output.
  char tmp[64];
  for (int prec = 15; prec <= 17; ++prec) {
    std::snprintf(tmp, sizeof(tmp), "%.*g", prec, v);
    if (std::strtod(tmp, nullptr) == v) break;
  }
  return std::snprintf(out, cap, "%s", tmp);
}

}  // namespace

extern "C" {

// Number of local TPU device nodes under root ("/" in production; test
// trees elsewhere). Never opens a device. Returns -1 on null root.
int tpumon_count_devices(const char* root) {
  if (root == nullptr) return -1;
  return scan_devices(root, nullptr, 0);
}

// Write newline-separated device paths into out (cap bytes, NUL-terminated).
// Returns the device count (which may exceed what fit in the buffer).
int tpumon_list_devices(const char* root, char* out, long cap) {
  if (root == nullptr || out == nullptr || cap <= 0) return -1;
  return scan_devices(root, out, cap);
}

// Render n exposition lines "prefix value\n" into out. prefixes[i] is the
// precomputed `metric{label="…"}` part (UTF-8, no trailing space). Returns
// bytes written, or -1 if out was too small (caller grows and retries).
long tpumon_render(const char** prefixes, const double* values, long n,
                   char* out, long cap) {
  if (prefixes == nullptr || values == nullptr || out == nullptr) return -1;
  long used = 0;
  char val[64];
  for (long i = 0; i < n; ++i) {
    const char* p = prefixes[i];
    long plen = (long)std::strlen(p);
    int vlen = format_value(values[i], val, sizeof(val));
    if (used + plen + 1 + vlen + 1 > cap) return -1;
    std::memcpy(out + used, p, plen);
    used += plen;
    out[used++] = ' ';
    std::memcpy(out + used, val, vlen);
    used += vlen;
    out[used++] = '\n';
  }
  return used;
}

// Like tpumon_render, but takes precomputed prefix lengths — the per-poll
// strlen over every prefix (~250 KB of label bytes at 256 chips) is pure
// waste when the caller's layout cache already knows the lengths.
long tpumon_render2(const char** prefixes, const int* plens,
                    const double* values, long n, char* out, long cap) {
  if (prefixes == nullptr || plens == nullptr || values == nullptr ||
      out == nullptr)
    return -1;
  long used = 0;
  char val[64];
  for (long i = 0; i < n; ++i) {
    long plen = plens[i];
    int vlen = format_value(values[i], val, sizeof(val));
    if (used + plen + 1 + vlen + 1 > cap) return -1;
    std::memcpy(out + used, prefixes[i], plen);
    used += plen;
    out[used++] = ' ';
    std::memcpy(out + used, val, vlen);
    used += vlen;
    out[used++] = '\n';
  }
  return used;
}

// Scan proc_root for processes holding device files whose readlink target
// starts with one of the newline-separated `prefixes`. Writes one record per
// (pid, device) pair into out: "pid\tdevice\tcomm\n" (comm sanitized: tabs/
// newlines replaced). The hot part of the exporter's process-attribution
// full scan — O(processes × fds) readlinks — kept native so a busy node's
// /proc walk stays off the Python interpreter (SURVEY.md §2.7 ledger;
// per-holder cgroup identity stays in the Python caller, holders are few).
//
// Returns the pair count on success (which may exceed what fit: caller
// compares against what it parsed and grows the buffer), -1 on bad args or
// unreadable proc_root (caller must treat as scan *failure*, not empty).
long tpumon_scan_proc(const char* proc_root, const char* prefixes,
                      char* out, long cap) {
  if (proc_root == nullptr || prefixes == nullptr || out == nullptr || cap <= 0)
    return -1;
  DIR* proc = opendir(proc_root);
  if (proc == nullptr) return -1;

  // Split prefixes once into (ptr, len) pairs; cap at 16 prefixes.
  const char* pfx[16];
  int pfx_len[16];
  int npfx = 0;
  for (const char* p = prefixes; *p && npfx < 16;) {
    const char* nl = std::strchr(p, '\n');
    int len = nl ? (int)(nl - p) : (int)std::strlen(p);
    if (len > 0) {
      pfx[npfx] = p;
      pfx_len[npfx] = len;
      ++npfx;
    }
    p = nl ? nl + 1 : p + len;
  }

  long count = 0;
  long used = 0;
  out[0] = '\0';
  struct dirent* pe;
  while ((pe = readdir(proc)) != nullptr) {
    if (!is_all_digits(pe->d_name)) continue;

    char fd_dir[4352];
    std::snprintf(fd_dir, sizeof(fd_dir), "%s/%s/fd", proc_root, pe->d_name);
    DIR* fds = opendir(fd_dir);
    if (fds == nullptr) continue;  // exited / unreadable: normal, skip

    // Per-process device dedupe (a process rarely holds >16 devices; extra
    // fds to the same device are the common case instead). A process that
    // genuinely exceeds the cap makes the whole scan return -1 so the
    // caller's (unbounded) Python walk takes over — silently truncating here
    // would make the verify path disagree with the cache forever.
    char devs[16][256];
    int ndevs = 0;
    bool overflow = false;
    struct dirent* fe;
    while ((fe = readdir(fds)) != nullptr) {
      if (fe->d_name[0] == '.') continue;
      char link_path[4608];
      std::snprintf(link_path, sizeof(link_path), "%s/%s", fd_dir, fe->d_name);
      char target[256];
      ssize_t tlen = readlink(link_path, target, sizeof(target) - 1);
      if (tlen <= 0) continue;
      target[tlen] = '\0';
      // "/dev/accel0 (deleted)" → "/dev/accel0" (recreated node, wedged
      // holder — exactly what the metric exists to expose).
      const char kDeleted[] = " (deleted)";
      size_t dlen = sizeof(kDeleted) - 1;
      if ((size_t)tlen > dlen &&
          std::strcmp(target + tlen - dlen, kDeleted) == 0)
        target[tlen - dlen] = '\0';
      bool match = false;
      for (int i = 0; i < npfx && !match; ++i)
        match = std::strncmp(target, pfx[i], pfx_len[i]) == 0;
      if (!match) continue;
      bool dup = false;
      for (int i = 0; i < ndevs && !dup; ++i)
        dup = std::strcmp(devs[i], target) == 0;
      if (dup) continue;
      if (ndevs == 16) {
        overflow = true;
        break;
      }
      std::snprintf(devs[ndevs++], sizeof(devs[0]), "%s", target);
    }
    closedir(fds);
    if (overflow) {
      closedir(proc);
      return -1;
    }
    if (ndevs == 0) continue;

    // comm, sanitized to match the Python scanner byte-for-byte (the verify
    // path compares Python-scanned holders against this cache): trim
    // leading/trailing ASCII whitespace, then '?'-replace interior tab and
    // newline (the record separators).
    char comm[64] = "";
    char comm_path[4352];
    std::snprintf(comm_path, sizeof(comm_path), "%s/%s/comm", proc_root,
                  pe->d_name);
    FILE* cf = std::fopen(comm_path, "re");
    if (cf != nullptr) {
      char raw[64];
      size_t n = std::fread(raw, 1, sizeof(raw) - 1, cf);
      std::fclose(cf);
      raw[n] = '\0';
      size_t start = 0;
      while (start < n && std::strchr(" \t\n\r\v\f", raw[start]) != nullptr &&
             raw[start] != '\0')
        ++start;
      while (n > start && std::strchr(" \t\n\r\v\f", raw[n - 1]) != nullptr &&
             raw[n - 1] != '\0')
        --n;
      std::memcpy(comm, raw + start, n - start);
      comm[n - start] = '\0';
      for (char* c = comm; *c; ++c)
        if (*c == '\t' || *c == '\n') *c = '?';
    }

    for (int i = 0; i < ndevs; ++i) {
      ++count;
      int n = std::snprintf(out + used, cap > used ? cap - used : 0,
                            "%s\t%s\t%s\n", pe->d_name, devs[i], comm);
      if (n > 0 && used + n < cap) used += n;
    }
  }
  closedir(proc);
  if (cap > 0) out[used < cap ? used : cap - 1] = '\0';
  return count;
}

// Whole-body value-only parse against a cached layout — the inverse of
// tpumon_render2, for the aggregator's steady state (the parse-side twin
// of the exporter's render layout cache). One entry per line of the
// previous round's body:
//   kinds[i] == 0: verbatim line (comment/blank) — the raw line must
//                  byte-equal keys[i].
//   kinds[i] == 1: name-filtered sample — the line must start with
//                  keys[i] followed by a space/tab; the rest is ignored.
//   kinds[i] == 2: consumed sample — prefix like kind 1, then the first
//                  whitespace token of the tail must parse fully as a
//                  float (written to out_values in kind-2 order); any
//                  trailing timestamp/garbage is ignored EXCEPT braces,
//                  which change the line's brace grammar entirely.
//
// Returns the number of kind-2 values written on a PERFECT whole-body
// match (every line consumed by its entry, every entry consumed), else
// -1 — the caller falls back to the Python parser, which owns all
// divergence/rebuild semantics. Deliberately conservative: anything the
// Python hit path would not accept byte-for-byte (leading whitespace,
// braces in tails, hex floats strtod would take but Python float()
// rejects, oversized value tokens) returns -1 rather than guessing.
long tpumon_parse_layout(const char* text, long n_text, const char** keys,
                         const int* klens, const unsigned char* kinds,
                         long n_entries, double* out_values) {
  if (text == nullptr || keys == nullptr || klens == nullptr ||
      kinds == nullptr || out_values == nullptr || n_text < 0)
    return -1;
  long i = 0;       // entry cursor
  long nvals = 0;   // kind-2 values written
  const char* p = text;
  const char* end = text + n_text;
  // Python's text.split("\n") yields a segment after the final newline
  // too (possibly empty) — mirror that exactly.
  for (;;) {
    const char* nl = (const char*)std::memchr(p, '\n', (size_t)(end - p));
    const char* line = p;
    long llen = (nl != nullptr ? nl : end) - p;
    if (i >= n_entries) return -1;  // body grew
    const char* key = keys[i];
    long klen = klens[i];
    unsigned char kind = kinds[i];
    ++i;
    if (kind == 0) {
      if (llen != klen || std::memcmp(line, key, (size_t)llen) != 0)
        return -1;
    } else {
      if (llen <= klen || std::memcmp(line, key, (size_t)klen) != 0)
        return -1;
      char b = line[klen];
      if (b != ' ' && b != '\t') return -1;
      if (kind == 2) {
        // Tail: optional ASCII whitespace, one value token, then
        // anything brace-free (the Python hit path drops timestamps the
        // same way). NULs can't slip through: the token is copied into a
        // bounded NUL-terminated buffer and must be consumed entirely.
        const char* t = line + klen + 1;
        const char* tend = line + llen;
        while (t < tend && (*t == ' ' || *t == '\t' || *t == '\r' ||
                            *t == '\v' || *t == '\f'))
          ++t;
        const char* tok = t;
        while (t < tend && *t != ' ' && *t != '\t' && *t != '\r' &&
               *t != '\v' && *t != '\f')
          ++t;
        long toklen = t - tok;
        if (toklen <= 0 || toklen >= 64) return -1;
        char val[64];
        std::memcpy(val, tok, (size_t)toklen);
        val[toklen] = '\0';
        // strtod accepts tokens Python float() does not — reject every
        // such shape so the native path never widens the grammar:
        // hex floats ("0x1p3"), nan payloads ("nan(123)"), and — under a
        // comma-decimal LC_NUMERIC in an embedding process — "1,5".
        for (long k = 0; k < toklen; ++k) {
          char c = val[k];
          if (c == 'x' || c == 'X' || c == '(' || c == ')' || c == ',')
            return -1;
        }
        char* endptr = nullptr;
        double v = std::strtod(val, &endptr);
        if (endptr != val + toklen) return -1;
        // The rest of the tail is ignored like Python's split()[0] — but
        // braces would change the reference brace grammar: reject.
        if (std::memchr(t, '{', (size_t)(tend - t)) != nullptr ||
            std::memchr(t, '}', (size_t)(tend - t)) != nullptr)
          return -1;
        out_values[nvals++] = v;
      }
    }
    if (nl == nullptr) break;
    p = nl + 1;
  }
  if (i != n_entries) return -1;  // body shrank
  return nvals;
}

// ABI version for the ctypes loader to sanity-check.
int tpumon_abi_version(void) { return 4; }

}  // extern "C"

// Native FASTA/FASTQ reader — this aligner's equivalent of the
// reference's C sequence-IO layer (bseq.c + kseq.h): gzip-transparent
// buffered parsing, U->T conversion (bseq.c:70-72), and block reads sized
// by base count (mm_bseq_read3, bseq.c:78).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  Records are
// returned in packed arenas (one for names+comments, one for seqs+quals)
// with per-record offsets, so a whole multi-megabase batch crosses the
// Python boundary in O(1) ctypes calls.
#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  gzFile fp = nullptr;
  int last = 0;      // lookahead character, 0 = none
  bool eof = false;

  // arenas for the current block
  std::vector<char> text;       // names + comments, NUL-separated
  std::vector<char> bases;      // seqs + quals (qual may be empty)
  std::vector<int64_t> name_off, comment_off, seq_off, seq_len, qual_off;

  int getc_() {
    if (last) {
      int c = last;
      last = 0;
      return c;
    }
    return gzgetc(fp);
  }
  void ungetc_(int c) { last = c; }
};

void fix_bases(char* s, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (s[i] == 'U') s[i] = 'T';
    else if (s[i] == 'u') s[i] = 't';
  }
}

// read one line into out (no newline); returns false on EOF with empty line
bool read_line(Reader* r, std::string* out) {
  out->clear();
  int c;
  while ((c = r->getc_()) >= 0 && c != '\n') {
    if (c != '\r') out->push_back(static_cast<char>(c));
  }
  return c >= 0 || !out->empty();
}

// parse one record; returns false at EOF or on a malformed record
// (qual length != seq length stops the stream, like kseq's -2 which
// mm_bseq_read treats as end-of-input, kseq.h:221-223)
bool read_record(Reader* r) {
  int c;
  while ((c = r->getc_()) >= 0 && c != '>' && c != '@') {
  }
  if (c < 0) return false;
  std::string header;
  read_line(r, &header);
  size_t sp = header.find_first_of(" \t");
  std::string name = header.substr(0, sp);
  std::string comment;
  if (sp != std::string::npos) {
    size_t b = header.find_first_not_of(" \t", sp);
    if (b != std::string::npos) comment = header.substr(b);
  }
  r->name_off.push_back(static_cast<int64_t>(r->text.size()));
  r->text.insert(r->text.end(), name.begin(), name.end());
  r->text.push_back('\0');
  r->comment_off.push_back(
      comment.empty() ? -1 : static_cast<int64_t>(r->text.size()));
  if (!comment.empty()) {
    r->text.insert(r->text.end(), comment.begin(), comment.end());
    r->text.push_back('\0');
  }

  // sequence: whole LINES until a line starting with '>', '@' (next
  // record, no qual) or '+' (FASTQ separator) — kseq.h:201-208: record
  // delimiters and the separator only count at line starts, so wrapped
  // (multi-line) FASTQ and mid-line '>' bytes parse exactly like kseq
  int64_t seq_start = static_cast<int64_t>(r->bases.size());
  bool have_plus = false;
  std::string line;
  while ((c = r->getc_()) >= 0) {
    if (c == '\n' || c == '\r') continue;   // blank lines
    if (c == '>' || c == '@') {
      r->ungetc_(c);
      break;
    }
    if (c == '+') {
      have_plus = true;
      read_line(r, &line);   // rest of the separator line
      break;
    }
    r->bases.push_back(static_cast<char>(c));
    read_line(r, &line);
    r->bases.insert(r->bases.end(), line.begin(), line.end());
  }
  int64_t n = static_cast<int64_t>(r->bases.size()) - seq_start;
  fix_bases(r->bases.data() + seq_start, n);
  r->seq_off.push_back(seq_start);
  r->seq_len.push_back(n);

  if (have_plus) {
    // quality: whole lines until >= seq length; any mismatch is
    // malformed input and ends the stream (kseq returns -2)
    int64_t qual_start = static_cast<int64_t>(r->bases.size());
    int64_t got = 0;
    while (got < n) {
      if (!read_line(r, &line)) break;
      r->bases.insert(r->bases.end(), line.begin(), line.end());
      got += static_cast<int64_t>(line.size());
    }
    if (got != n) {
      // drop the malformed record entirely and stop
      r->bases.resize(static_cast<size_t>(seq_start));
      r->name_off.pop_back();
      r->comment_off.pop_back();
      r->seq_off.pop_back();
      r->seq_len.pop_back();
      return false;
    }
    r->qual_off.push_back(qual_start);
  } else {
    r->qual_off.push_back(-1);
  }
  return true;
}

}  // namespace

extern "C" {

void* fxr_open(const char* path) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return nullptr;
  gzbuffer(fp, 1 << 20);
  Reader* r = new Reader();
  r->fp = fp;
  return r;
}

// Read records until ~max_bases accumulated (at least one record).
// Returns the number of records (0 = EOF).
int64_t fxr_read_block(void* h, int64_t max_bases) {
  Reader* r = static_cast<Reader*>(h);
  r->text.clear();
  r->bases.clear();
  r->name_off.clear();
  r->comment_off.clear();
  r->seq_off.clear();
  r->seq_len.clear();
  r->qual_off.clear();
  if (r->eof) return 0;
  int64_t total = 0;
  while (total < max_bases) {
    if (!read_record(r)) {
      r->eof = true;
      break;
    }
    total += r->seq_len.back();
  }
  if (r->eof) {
    // distinguish hard IO/zlib errors (unreadable path, truncated gzip)
    // from genuine EOF: the python fallback raises on these, and a
    // silent empty result would look like an empty input file
    int errnum = 0;
    gzerror(r->fp, &errnum);
    if (errnum != Z_OK && errnum != Z_STREAM_END) return -1;
  }
  return static_cast<int64_t>(r->seq_len.size());
}

const char* fxr_text(void* h) { return static_cast<Reader*>(h)->text.data(); }
const char* fxr_bases(void* h) {
  return static_cast<Reader*>(h)->bases.data();
}
int64_t fxr_bases_len(void* h) {
  return static_cast<int64_t>(static_cast<Reader*>(h)->bases.size());
}
const int64_t* fxr_name_off(void* h) {
  return static_cast<Reader*>(h)->name_off.data();
}
const int64_t* fxr_comment_off(void* h) {
  return static_cast<Reader*>(h)->comment_off.data();
}
const int64_t* fxr_seq_off(void* h) {
  return static_cast<Reader*>(h)->seq_off.data();
}
const int64_t* fxr_seq_len(void* h) {
  return static_cast<Reader*>(h)->seq_len.data();
}
const int64_t* fxr_qual_off(void* h) {
  return static_cast<Reader*>(h)->qual_off.data();
}

void fxr_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r->fp) gzclose(r->fp);
  delete r;
}

}  // extern "C"

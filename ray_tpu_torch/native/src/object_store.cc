// Shared-memory object store — the plasma equivalent for the TPU framework.
//
// Reference design being re-built (not copied): Ray's plasma store
// (`src/ray/object_manager/plasma/store.h`, `object_lifecycle_manager.h`,
// `eviction_policy.h`) is a separate server process with a socket protocol and
// fd passing.  For a TPU-first single-node data plane we instead put ALL store
// state — entry table, allocator, locks — inside one file-backed mmap in
// /dev/shm that every process maps at attach time.  There is no store server:
// create/seal/get are direct shm operations under a process-shared robust
// mutex, which removes the per-op socket round trip that bounds plasma at
// ~6k ops/s (BASELINE.md) while keeping the same semantics:
//
//   * objects are immutable after seal
//   * clients hold pins (refcounts) while they hold views
//   * LRU eviction of sealed, unpinned objects when allocation fails
//   * create-then-seal two-phase writes (writer fills the buffer in place)
//
// Memory layout of the mapped file:
//   [Header][EntryTable: cap slots][heap ...]
// Heap: address-ordered free list with coalescing (first-fit).
//
// Build: g++ -O3 -fPIC -shared -pthread -o librt_store.so object_store.cc

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x525450555354524FULL;  // "RTPUSTRO"
constexpr uint32_t kKeySize = 20;                   // ObjectID size
constexpr uint64_t kAlign = 64;

enum EntryState : uint32_t {
  kEmpty = 0,
  kCreated = 1,
  kSealed = 2,
  kTombstone = 3,
};

struct Entry {
  uint8_t key[kKeySize];
  uint64_t offset;     // data offset from base of mapping
  uint64_t size;       // payload size
  uint64_t lru_tick;   // last touch
  uint32_t state;
  uint32_t refcount;   // client pins
};

struct FreeBlock {
  uint64_t size;       // includes this header
  uint64_t next;       // offset of next free block, 0 = end
};

struct Header {
  uint64_t magic;
  uint64_t file_size;
  uint64_t table_cap;      // number of Entry slots (power of two)
  uint64_t table_off;
  uint64_t heap_off;
  uint64_t heap_size;
  uint64_t free_head;      // offset of first free block (0 = none)
  uint64_t lru_clock;
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t num_evictions;
  pthread_mutex_t mutex;
};

struct Store {
  uint8_t* base;
  uint64_t mapped_size;
  Header* hdr;
  Entry* table;
};

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

uint64_t hash_key(const uint8_t* key) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kKeySize; i++) {
    h ^= key[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class Guard {
 public:
  explicit Guard(Store* s) : s_(s) {
    int rc = pthread_mutex_lock(&s_->hdr->mutex);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is consistent enough for our
      // ops (each op's writes are ordered so partial entries stay kCreated
      // and are reclaimable).
      pthread_mutex_consistent(&s_->hdr->mutex);
    }
  }
  ~Guard() { pthread_mutex_unlock(&s_->hdr->mutex); }

 private:
  Store* s_;
};

// --- allocator: address-ordered free list with coalescing ------------------

uint64_t heap_alloc(Store* s, uint64_t want) {
  want = align_up(want < sizeof(FreeBlock) ? sizeof(FreeBlock) : want);
  Header* h = s->hdr;
  uint64_t prev = 0;
  uint64_t cur = h->free_head;
  while (cur) {
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(s->base + cur);
    if (fb->size >= want) {
      uint64_t remain = fb->size - want;
      if (remain >= align_up(sizeof(FreeBlock))) {
        // split: tail remains free
        uint64_t tail = cur + want;
        FreeBlock* tb = reinterpret_cast<FreeBlock*>(s->base + tail);
        tb->size = remain;
        tb->next = fb->next;
        if (prev) reinterpret_cast<FreeBlock*>(s->base + prev)->next = tail;
        else h->free_head = tail;
      } else {
        want = fb->size;  // hand out whole block
        if (prev) reinterpret_cast<FreeBlock*>(s->base + prev)->next = fb->next;
        else h->free_head = fb->next;
      }
      h->bytes_in_use += want;
      return cur;
    }
    prev = cur;
    cur = fb->next;
  }
  return 0;
}

void heap_free(Store* s, uint64_t off, uint64_t size) {
  size = align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
  Header* h = s->hdr;
  h->bytes_in_use -= size;
  // address-ordered insert
  uint64_t prev = 0, cur = h->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(s->base + cur)->next;
  }
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(s->base + off);
  nb->size = size;
  nb->next = cur;
  if (prev) reinterpret_cast<FreeBlock*>(s->base + prev)->next = off;
  else h->free_head = off;
  // coalesce with next
  if (cur && off + nb->size == cur) {
    FreeBlock* cb = reinterpret_cast<FreeBlock*>(s->base + cur);
    nb->size += cb->size;
    nb->next = cb->next;
  }
  // coalesce with prev
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(s->base + prev);
    if (prev + pb->size == off) {
      pb->size += nb->size;
      pb->next = nb->next;
    }
  }
}

// --- table ------------------------------------------------------------------

Entry* find_entry(Store* s, const uint8_t* key) {
  uint64_t cap = s->hdr->table_cap;
  uint64_t idx = hash_key(key) & (cap - 1);
  for (uint64_t probe = 0; probe < cap; probe++) {
    Entry* e = &s->table[(idx + probe) & (cap - 1)];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kTombstone && memcmp(e->key, key, kKeySize) == 0) return e;
  }
  return nullptr;
}

Entry* find_slot(Store* s, const uint8_t* key) {
  uint64_t cap = s->hdr->table_cap;
  uint64_t idx = hash_key(key) & (cap - 1);
  Entry* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < cap; probe++) {
    Entry* e = &s->table[(idx + probe) & (cap - 1)];
    if (e->state == kEmpty) return first_tomb ? first_tomb : e;
    if (e->state == kTombstone) {
      if (!first_tomb) first_tomb = e;
    } else if (memcmp(e->key, key, kKeySize) == 0) {
      return e;  // caller checks state for "exists"
    }
  }
  return first_tomb;
}

void erase_entry(Store* s, Entry* e) {
  heap_free(s, e->offset, e->size);
  e->state = kTombstone;
  e->refcount = 0;
  s->hdr->num_objects--;
}

// Evict sealed, unpinned objects in LRU order until at least `need` bytes can
// be allocated.  Mirrors plasma's EvictionPolicy/LRUCache
// (`src/ray/object_manager/plasma/eviction_policy.h:160,105`).
bool evict_for(Store* s, uint64_t need) {
  for (;;) {
    uint64_t off = heap_alloc(s, need);
    if (off) {
      heap_free(s, off, need);  // probe only; caller allocates for real
      return true;
    }
    // find LRU victim
    Entry* victim = nullptr;
    uint64_t cap = s->hdr->table_cap;
    for (uint64_t i = 0; i < cap; i++) {
      Entry* e = &s->table[i];
      if (e->state == kSealed && e->refcount == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) return false;
    erase_entry(s, victim);
    s->hdr->num_evictions++;
  }
}

}  // namespace

extern "C" {

// Create + initialize a store file.  Returns 0 on success.
int rt_store_init(const char* path, uint64_t capacity_bytes, uint64_t table_cap) {
  // table_cap must be a power of two
  if (table_cap == 0 || (table_cap & (table_cap - 1))) return -EINVAL;
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return -errno;
  uint64_t table_off = align_up(sizeof(Header));
  uint64_t heap_off = align_up(table_off + table_cap * sizeof(Entry));
  uint64_t file_size = align_up(heap_off + capacity_bytes);
  if (ftruncate(fd, (off_t)file_size) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  void* mem = mmap(nullptr, file_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;
  uint8_t* base = static_cast<uint8_t*>(mem);
  Header* h = reinterpret_cast<Header*>(base);
  memset(h, 0, sizeof(Header));
  h->file_size = file_size;
  h->table_cap = table_cap;
  h->table_off = table_off;
  h->heap_off = heap_off;
  h->heap_size = file_size - heap_off;
  // one giant free block
  FreeBlock* fb = reinterpret_cast<FreeBlock*>(base + heap_off);
  fb->size = h->heap_size;
  fb->next = 0;
  h->free_head = heap_off;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  pthread_mutexattr_destroy(&attr);
  h->magic = kMagic;
  munmap(mem, file_size);
  return 0;
}

// Attach to an existing store.  Returns opaque handle or nullptr.
void* rt_store_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = reinterpret_cast<Header*>(mem);
  if (h->magic != kMagic || h->file_size != (uint64_t)st.st_size) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->mapped_size = h->file_size;
  s->hdr = h;
  s->table = reinterpret_cast<Entry*>(s->base + h->table_off);
  return s;
}

void rt_store_detach(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->mapped_size);
  delete s;
}

// Create an object buffer of `size` bytes.  Writes the data offset (from file
// start) into *out_offset.  The object is pinned (refcount 1) and unsealed.
// `allow_evict` = 0 disables LRU eviction: the caller prefers failing (and
// spilling the NEW object to disk) over silently dropping sealed data.
//  0: ok   -EEXIST: already exists   -ENOMEM: no space (even after eviction)
int rt_create_opts(void* handle, const uint8_t* key, uint64_t size,
                   uint64_t* out_offset, int allow_evict) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* existing = find_entry(s, key);
  if (existing && existing->state != kTombstone) return -EEXIST;
  uint64_t want = size ? size : 1;
  if (allow_evict) {
    if (!evict_for(s, align_up(want))) return -ENOMEM;
  }
  uint64_t off = heap_alloc(s, want);
  if (!off) return -ENOMEM;
  Entry* e = find_slot(s, key);
  if (!e) {
    heap_free(s, off, want);
    return -ENOSPC;  // table full
  }
  memcpy(e->key, key, kKeySize);
  e->offset = off;
  e->size = size;
  e->state = kCreated;
  e->refcount = 1;
  e->lru_tick = ++s->hdr->lru_clock;
  s->hdr->num_objects++;
  *out_offset = off;
  return 0;
}

int rt_create(void* handle, const uint8_t* key, uint64_t size,
              uint64_t* out_offset) {
  return rt_create_opts(handle, key, size, out_offset, 1);
}

int rt_seal(void* handle, const uint8_t* key) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  if (!e) return -ENOENT;
  if (e->state == kSealed) return 0;
  e->state = kSealed;
  return 0;
}

// Get a sealed object: pins it and returns offset+size.
//  0: ok   -ENOENT: not present   -EAGAIN: present but unsealed
int rt_get(void* handle, const uint8_t* key, uint64_t* out_offset,
           uint64_t* out_size) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  if (!e) return -ENOENT;
  if (e->state != kSealed) return -EAGAIN;
  e->refcount++;
  e->lru_tick = ++s->hdr->lru_clock;
  *out_offset = e->offset;
  *out_size = e->size;
  return 0;
}

int rt_release(void* handle, const uint8_t* key) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  if (!e) return -ENOENT;
  if (e->refcount > 0) e->refcount--;
  return 0;
}

int rt_contains(void* handle, const uint8_t* key) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  return (e && e->state == kSealed) ? 1 : 0;
}

// Delete an object (frees immediately if unpinned; else marks — the last
// release does NOT free in this minimal version, deletion requires unpinned).
int rt_delete(void* handle, const uint8_t* key) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  if (!e) return -ENOENT;
  if (e->refcount > 0) return -EBUSY;
  erase_entry(s, e);
  return 0;
}

// Abort an in-progress create (e.g. writer failed between create and seal).
int rt_abort(void* handle, const uint8_t* key) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  Entry* e = find_entry(s, key);
  if (!e) return -ENOENT;
  if (e->state == kSealed) return -EINVAL;
  erase_entry(s, e);
  return 0;
}

struct StoreStats {
  uint64_t capacity;
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t num_evictions;
};

void rt_stats(void* handle, StoreStats* out) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s);
  out->capacity = s->hdr->heap_size;
  out->bytes_in_use = s->hdr->bytes_in_use;
  out->num_objects = s->hdr->num_objects;
  out->num_evictions = s->hdr->num_evictions;
}

}  // extern "C"

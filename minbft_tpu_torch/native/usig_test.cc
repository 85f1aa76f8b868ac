/* Native USIG test — ports the reference enclave test
 * (reference usig/sgx/test/usig_test.c:34-60): init/destroy, counter
 * monotonicity from 1, seal/unseal round-trip, plus signature validity and
 * forgery rejection.  Built and run by usig/native.py build_test().
 */

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "usig.h"

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      return 1;                                                         \
    }                                                                   \
  } while (0)

int main() {
  usig_t *u = nullptr;
  CHECK(usig_init(&u, nullptr, 0) == USIG_OK);

  uint64_t epoch = 0;
  CHECK(usig_get_epoch(u, &epoch) == USIG_OK);

  uint8_t pub[64];
  CHECK(usig_get_pubkey(u, pub) == USIG_OK);

  /* counters start at 1 and increase by exactly 1 per certificate
   * (reference usig_test.c:34-60). */
  uint8_t digest[32];
  std::memset(digest, 0xAB, sizeof digest);
  uint8_t sig[64];
  for (uint64_t expect = 1; expect <= 5; ++expect) {
    uint64_t counter = 0;
    CHECK(usig_create_ui(u, digest, &counter, sig) == USIG_OK);
    CHECK(counter == expect);
    CHECK(usig_verify_ui(pub, epoch, digest, counter, sig) == USIG_OK);
    /* wrong counter / digest / epoch must not verify */
    CHECK(usig_verify_ui(pub, epoch, digest, counter + 1, sig) != USIG_OK);
    uint8_t bad[32];
    std::memcpy(bad, digest, 32);
    bad[0] ^= 1;
    CHECK(usig_verify_ui(pub, epoch, bad, counter, sig) != USIG_OK);
    CHECK(usig_verify_ui(pub, epoch ^ 1, digest, counter, sig) != USIG_OK);
    /* corrupted signature */
    sig[10] ^= 0x40;
    CHECK(usig_verify_ui(pub, epoch, digest, counter, sig) != USIG_OK);
    sig[10] ^= 0x40;
  }

  /* seal -> unseal: same key (same pubkey, valid sigs) but a FRESH epoch
   * (reference usig.c:168-186 draws a new random epoch on every init);
   * counter restarts at 1 (volatile state, reference usig.c:140-166). */
  size_t need = 0;
  CHECK(usig_sealed_size(u, &need) == USIG_OK && need > 4);
  std::vector<uint8_t> blob(need);
  size_t sealed_len = 0;
  CHECK(usig_seal(u, blob.data(), blob.size(), &sealed_len) == USIG_OK);
  CHECK(sealed_len == need);

  usig_t *u2 = nullptr;
  CHECK(usig_init(&u2, blob.data(), sealed_len) == USIG_OK);
  uint64_t epoch2 = 0;
  CHECK(usig_get_epoch(u2, &epoch2) == USIG_OK && epoch2 != epoch);
  uint8_t pub2[64];
  CHECK(usig_get_pubkey(u2, pub2) == USIG_OK);
  CHECK(std::memcmp(pub, pub2, 64) == 0);
  uint64_t counter = 0;
  CHECK(usig_create_ui(u2, digest, &counter, sig) == USIG_OK);
  CHECK(counter == 1);
  /* the restored instance's counter-1 certificate binds the NEW epoch:
   * it can never collide with the old instance's (epoch, cv=1) cert. */
  CHECK(usig_verify_ui(pub, epoch2, digest, counter, sig) == USIG_OK);
  CHECK(usig_verify_ui(pub, epoch, digest, counter, sig) != USIG_OK);

  /* malformed sealed blobs are rejected */
  usig_t *u3 = nullptr;
  CHECK(usig_init(&u3, blob.data(), 3) == USIG_ERR_SEALED);
  blob[0] ^= 1;
  CHECK(usig_init(&u3, blob.data(), sealed_len) == USIG_ERR_SEALED);
  blob[0] ^= 1;

  /* v1 blobs (magic || epoch_be8 || key) still restore the key, with the
   * stored epoch ignored. */
  {
    std::vector<uint8_t> v1;
    v1.push_back('U'); v1.push_back('S'); v1.push_back('G'); v1.push_back('1');
    for (int i = 0; i < 8; ++i)
      v1.push_back(static_cast<uint8_t>(epoch >> (56 - 8 * i)));
    v1.insert(v1.end(), blob.begin() + 4, blob.begin() + sealed_len);
    usig_t *u4 = nullptr;
    CHECK(usig_init(&u4, v1.data(), v1.size()) == USIG_OK);
    uint64_t epoch4 = 0;
    CHECK(usig_get_epoch(u4, &epoch4) == USIG_OK && epoch4 != epoch);
    uint8_t pub4[64];
    CHECK(usig_get_pubkey(u4, pub4) == USIG_OK);
    CHECK(std::memcmp(pub, pub4, 64) == 0);
    CHECK(usig_destroy(u4) == USIG_OK);
  }

  /* small-buffer seal is refused */
  uint8_t tiny[4];
  size_t out_len = 0;
  CHECK(usig_seal(u, tiny, sizeof tiny, &out_len) == USIG_ERR_BUFSZ);

  /* encrypted sealing (v3): round-trips under the right secret, is
   * refused without one or with the wrong one, and the blob holds no
   * plaintext DER (sgx_seal_data confidentiality analogue). */
  {
    const uint8_t secret[] = "operator-secret";
    size_t need3 = 0;
    CHECK(usig_sealed_size2(u, sizeof secret - 1, &need3) == USIG_OK);
    std::vector<uint8_t> enc(need3);
    size_t enc_len = 0;
    CHECK(usig_seal2(u, secret, sizeof secret - 1, enc.data(), enc.size(),
                     &enc_len) == USIG_OK);
    CHECK(enc_len == need3);
    /* the plaintext DER (from the v2 blob) must not appear in the
     * ciphertext */
    const uint8_t *der = blob.data() + 4;
    size_t der_len = sealed_len - 4;
    bool found = false;
    for (size_t i = 0; i + der_len <= enc_len && !found; ++i)
      found = std::memcmp(enc.data() + i, der, der_len) == 0;
    CHECK(!found);

    usig_t *u5 = nullptr;
    CHECK(usig_init2(&u5, enc.data(), enc_len, secret, sizeof secret - 1) ==
          USIG_OK);
    uint8_t pub5[64];
    CHECK(usig_get_pubkey(u5, pub5) == USIG_OK);
    CHECK(std::memcmp(pub, pub5, 64) == 0);
    CHECK(usig_destroy(u5) == USIG_OK);

    usig_t *u6 = nullptr;
    CHECK(usig_init2(&u6, enc.data(), enc_len, nullptr, 0) ==
          USIG_ERR_SECRET);
    const uint8_t wrong[] = "wrong-secret";
    CHECK(usig_init2(&u6, enc.data(), enc_len, wrong, sizeof wrong - 1) ==
          USIG_ERR_SECRET);
  }

  /* Concurrent certification hammer:
   * usig.h promises usig_create_ui is thread-safe behind an internal
   * lock (the reference enclave's ecallLock).  N threads certify
   * concurrently on one instance; the counter values they observe must
   * be a permutation of one contiguous range — a duplicate or a gap
   * would be exactly the monotonicity break the whole protocol leans
   * on.  Built under ThreadSanitizer this also proves the signing path
   * itself (shared EVP contexts would tear here) is data-race free. */
  {
    usig_t *uc = nullptr;
    CHECK(usig_init(&uc, nullptr, 0) == USIG_OK);
    const int kThreads = 8;
    const int kPerThread = 64;
    std::vector<std::vector<uint64_t>> seen(kThreads);
    std::vector<std::thread> workers;
    std::vector<int> fails(kThreads, 0);
    for (int t = 0; t < kThreads; ++t) {
      workers.emplace_back([&, t] {
        uint8_t d[32];
        std::memset(d, 0x30 + t, sizeof d);
        uint8_t s[64];
        for (int i = 0; i < kPerThread; ++i) {
          uint64_t cv = 0;
          if (usig_create_ui(uc, d, &cv, s) != USIG_OK) {
            ++fails[t];
            return;
          }
          seen[t].push_back(cv);
        }
      });
    }
    for (auto &w : workers) w.join();
    std::vector<uint64_t> all;
    for (int t = 0; t < kThreads; ++t) {
      CHECK(fails[t] == 0);
      all.insert(all.end(), seen[t].begin(), seen[t].end());
    }
    std::sort(all.begin(), all.end());
    CHECK(all.size() == static_cast<size_t>(kThreads * kPerThread));
    for (size_t i = 0; i < all.size(); ++i)
      CHECK(all[i] == i + 1);  /* contiguous from 1: no duplicate, no gap */
    CHECK(usig_destroy(uc) == USIG_OK);
  }

  CHECK(usig_destroy(u) == USIG_OK);
  CHECK(usig_destroy(u2) == USIG_OK);

  std::printf("usig_test: all checks passed (%s)\n", usig_native_version());
  return 0;
}

/* Hand-declared prototypes for the subset of OpenSSL 3 (libcrypto.so.3)
 * this module uses.  The image ships the shared library but not the
 * development headers, so the needed functions are declared here verbatim
 * from the stable public API (all exported, none deprecated-removed).
 * usig/native.py's build links against the versioned .so directly.
 */

#ifndef MINBFT_TPU_NATIVE_OSSL_H
#define MINBFT_TPU_NATIVE_OSSL_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_pkey_ctx_st EVP_PKEY_CTX;
typedef struct ossl_lib_ctx_st OSSL_LIB_CTX;
typedef struct evp_md_st EVP_MD;
typedef struct engine_st ENGINE;

/* Key generation (OpenSSL 3 one-shot helper). */
EVP_PKEY *EVP_PKEY_Q_keygen(OSSL_LIB_CTX *libctx, const char *propq,
                            const char *type, ...);

/* Sign / verify a precomputed digest (DER-encoded ECDSA signature). */
EVP_PKEY_CTX *EVP_PKEY_CTX_new(EVP_PKEY *pkey, ENGINE *e);
void EVP_PKEY_CTX_free(EVP_PKEY_CTX *ctx);
int EVP_PKEY_sign_init(EVP_PKEY_CTX *ctx);
int EVP_PKEY_sign(EVP_PKEY_CTX *ctx, unsigned char *sig, size_t *siglen,
                  const unsigned char *tbs, size_t tbslen);
int EVP_PKEY_verify_init(EVP_PKEY_CTX *ctx);
int EVP_PKEY_verify(EVP_PKEY_CTX *ctx, const unsigned char *sig,
                    size_t siglen, const unsigned char *tbs, size_t tbslen);

/* Raw public-key bytes (uncompressed SEC1 point). */
int EVP_PKEY_get_octet_string_param(const EVP_PKEY *pkey,
                                    const char *key_name, unsigned char *buf,
                                    size_t max_buf_sz, size_t *out_sz);

/* Build a key from encoded parts (used for unsealing / verification). */
EVP_PKEY *EVP_PKEY_new_raw_public_key_ex(OSSL_LIB_CTX *libctx,
                                         const char *keytype,
                                         const char *propq,
                                         const unsigned char *key,
                                         size_t keylen);

/* Classic DER (de)serialization — still exported in OpenSSL 3. */
int i2d_PrivateKey(const EVP_PKEY *a, unsigned char **pp);
EVP_PKEY *d2i_AutoPrivateKey(EVP_PKEY **a, const unsigned char **pp,
                             long length);

void EVP_PKEY_free(EVP_PKEY *pkey);

/* SHA-256 one-shot. */
int EVP_Digest(const void *data, size_t count, unsigned char *md,
               unsigned int *size, const EVP_MD *type, ENGINE *impl);
const EVP_MD *EVP_sha256(void);

/* CSPRNG. */
int RAND_bytes(unsigned char *buf, int num);

/* AES-256-GCM + PBKDF2 (encrypted sealing, v3 blobs).  Ctrl constants
 * are the stable AEAD values from <openssl/evp.h>. */
typedef struct evp_cipher_st EVP_CIPHER;
typedef struct evp_cipher_ctx_st EVP_CIPHER_CTX;
const EVP_CIPHER *EVP_aes_256_gcm(void);
EVP_CIPHER_CTX *EVP_CIPHER_CTX_new(void);
void EVP_CIPHER_CTX_free(EVP_CIPHER_CTX *ctx);
int EVP_CIPHER_CTX_ctrl(EVP_CIPHER_CTX *ctx, int type, int arg, void *ptr);
int EVP_EncryptInit_ex(EVP_CIPHER_CTX *ctx, const EVP_CIPHER *cipher,
                       ENGINE *impl, const unsigned char *key,
                       const unsigned char *iv);
int EVP_EncryptUpdate(EVP_CIPHER_CTX *ctx, unsigned char *out, int *outl,
                      const unsigned char *in, int inl);
int EVP_EncryptFinal_ex(EVP_CIPHER_CTX *ctx, unsigned char *out, int *outl);
int EVP_DecryptInit_ex(EVP_CIPHER_CTX *ctx, const EVP_CIPHER *cipher,
                       ENGINE *impl, const unsigned char *key,
                       const unsigned char *iv);
int EVP_DecryptUpdate(EVP_CIPHER_CTX *ctx, unsigned char *out, int *outl,
                      const unsigned char *in, int inl);
int EVP_DecryptFinal_ex(EVP_CIPHER_CTX *ctx, unsigned char *out, int *outl);
#define EVP_CTRL_GCM_SET_IVLEN 0x9
#define EVP_CTRL_GCM_GET_TAG 0x10
#define EVP_CTRL_GCM_SET_TAG 0x11
int PKCS5_PBKDF2_HMAC(const char *pass, int passlen,
                      const unsigned char *salt, int saltlen, int iter,
                      const EVP_MD *digest, int keylen, unsigned char *out);

/* EC pubkey-from-point (verification path): build via OSSL_PARAM is
 * heavyweight without headers; instead use EVP_PKEY_fromdata with an
 * OSSL_PARAM array we lay out manually. */
typedef struct ossl_param_st {
  const char *key;
  unsigned int data_type;
  void *data;
  size_t data_size;
  size_t return_size;
} OSSL_PARAM;

#define OSSL_PARAM_UTF8_STRING 4
#define OSSL_PARAM_OCTET_STRING 5

EVP_PKEY_CTX *EVP_PKEY_CTX_new_from_name(OSSL_LIB_CTX *libctx,
                                         const char *name,
                                         const char *propquery);
int EVP_PKEY_fromdata_init(EVP_PKEY_CTX *ctx);
int EVP_PKEY_fromdata(EVP_PKEY_CTX *ctx, EVP_PKEY **ppkey, int selection,
                      OSSL_PARAM params[]);

/* selection constant: public key portions */
#define EVP_PKEY_PUBLIC_KEY 0x86

#ifdef __cplusplus
}
#endif

#endif /* MINBFT_TPU_NATIVE_OSSL_H */

/* Stub implementation of the vendor FPGA driver API (reference fpga.h:37-62).
 *
 * The reference fork links against a binary-only `libfpgadrv.a`; this stub lets us
 * build and run the reference binary for GOLDEN OUTPUT GENERATION ONLY, by routing
 * every submitted chaining-DP task through the fork's own bit-exact software model
 * `fpga_work()` (reference map.c:484-568) and feeding results back through a small
 * blocking queue that `fpga_get_retbuf()` pops (consumed by recv_task_thread,
 * reference fpga_chaindp.c:228-271).
 *
 * This file is original code written for this repository's test harness; it is
 * not part of the aligner itself.
 */
#include <stdlib.h>
#include <string.h>
#include <stdio.h>
#include <pthread.h>

#define TYPE_CD 1

typedef enum { BUF_TYPE_SW = 0, BUF_TYPE_CD = 1, BUF_TYPE_CS = 3 } BUF_TYPE;
typedef enum { RET_TYPE_SW = 0, RET_TYPE_CD = 1, RET_TYPE_CS = 3 } RET_TYPE;

/* software model, defined in reference map.c */
extern void *fpga_work(void *buf, int size, int *result_size);

#define QCAP 65536
static struct { void *buf; int size; } q[QCAP];
static int q_head = 0, q_tail = 0, q_n = 0, q_closed = 0;
static pthread_mutex_t q_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t q_cv_pop = PTHREAD_COND_INITIALIZER;
static pthread_cond_t q_cv_push = PTHREAD_COND_INITIALIZER;
static pthread_mutex_t work_mu = PTHREAD_MUTEX_INITIALIZER;

int fpga_init(int flag) { (void)flag; return 0; }
int fpga_init_noreset(int noblock) { (void)noblock; return 0; }
void fpga_finalize(void) {}
int fpga_init_sw(void *parameters) { (void)parameters; return 0; }
int fpga_send_sw(int id, int qlen, char *qs, int tlen, char *ts)
{ (void)id; (void)qlen; (void)qs; (void)tlen; (void)ts; return 0; }
void fpga_set_block(void) {}
int get_queue_num(void) { return q_n; }
void fpga_set_params(int bw, int is_cdna, int max_skip, int min_sc, int flag, int max_occ)
{ (void)bw; (void)is_cdna; (void)max_skip; (void)min_sc; (void)flag; (void)max_occ; }
void fpga_test(void) {}
void fpga_load_index(void *addr, int size, int type) { (void)addr; (void)size; (void)type; }

void *fpga_get_writebuf(unsigned long size, BUF_TYPE type)
{ (void)type; return malloc(size); }

void *fpga_get_writebuf_thread(unsigned long size, BUF_TYPE type, int tid)
{ (void)type; (void)tid; return malloc(size); }

int fpga_writebuf_submit(void *addr, unsigned int size, unsigned int type)
{
    int out_size = 0;
    void *out;
    if (type != TYPE_CD) { free(addr); return 0; }
    pthread_mutex_lock(&work_mu);
    out = fpga_work(addr, (int)size, &out_size);
    pthread_mutex_unlock(&work_mu);
    free(addr);
    pthread_mutex_lock(&q_mu);
    while (q_n == QCAP) pthread_cond_wait(&q_cv_push, &q_mu);
    q[q_tail].buf = out; q[q_tail].size = out_size;
    q_tail = (q_tail + 1) % QCAP; q_n++;
    pthread_cond_signal(&q_cv_pop);
    pthread_mutex_unlock(&q_mu);
    return 0;
}

void *fpga_get_retbuf(int *len, RET_TYPE type)
{
    void *buf;
    (void)type;
    pthread_mutex_lock(&q_mu);
    while (q_n == 0 && !q_closed) pthread_cond_wait(&q_cv_pop, &q_mu);
    if (q_n == 0 && q_closed) { pthread_mutex_unlock(&q_mu); *len = 0; return NULL; }
    buf = q[q_head].buf; *len = q[q_head].size;
    q_head = (q_head + 1) % QCAP; q_n--;
    pthread_cond_signal(&q_cv_push);
    pthread_mutex_unlock(&q_mu);
    return buf;
}

int fpga_release_retbuf(void *addr) { free(addr); return 0; }

void fpga_exit_block(void)
{
    pthread_mutex_lock(&q_mu);
    q_closed = 1;
    pthread_cond_broadcast(&q_cv_pop);
    pthread_mutex_unlock(&q_mu);
}

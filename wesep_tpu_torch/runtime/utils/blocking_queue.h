// Bounded blocking producer/consumer queue.
// The port's copy of runtime/utils/blocking_queue.h.
#ifndef WESEP_TPU_TORCH_RUNTIME_UTILS_BLOCKING_QUEUE_H_
#define WESEP_TPU_TORCH_RUNTIME_UTILS_BLOCKING_QUEUE_H_

#include <condition_variable>
#include <deque>
#include <limits>
#include <mutex>
#include <utility>
#include <vector>

namespace wesep {

template <typename T>
class BlockingQueue {
 public:
  explicit BlockingQueue(size_t capacity = std::numeric_limits<int>::max())
      : capacity_(capacity) {}

  BlockingQueue(const BlockingQueue&) = delete;
  BlockingQueue& operator=(const BlockingQueue&) = delete;

  void Push(T&& value) {
    std::unique_lock<std::mutex> lock(mutex_);
    not_full_.wait(lock, [this] { return queue_.size() < capacity_; });
    queue_.push_back(std::move(value));
    not_empty_.notify_one();
  }

  void Push(const T& value) {
    std::unique_lock<std::mutex> lock(mutex_);
    not_full_.wait(lock, [this] { return queue_.size() < capacity_; });
    queue_.push_back(value);
    not_empty_.notify_one();
  }

  T Pop() {
    std::unique_lock<std::mutex> lock(mutex_);
    not_empty_.wait(lock, [this] { return !queue_.empty(); });
    T value(std::move(queue_.front()));
    queue_.pop_front();
    not_full_.notify_one();
    return value;
  }

  bool Empty() const {
    std::lock_guard<std::mutex> lock(mutex_);
    return queue_.empty();
  }

  size_t Size() const {
    std::lock_guard<std::mutex> lock(mutex_);
    return queue_.size();
  }

  void Clear() {
    std::lock_guard<std::mutex> lock(mutex_);
    queue_.clear();
    not_full_.notify_all();
  }

 private:
  size_t capacity_;
  mutable std::mutex mutex_;
  std::condition_variable not_full_;
  std::condition_variable not_empty_;
  std::deque<T> queue_;
};

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_UTILS_BLOCKING_QUEUE_H_

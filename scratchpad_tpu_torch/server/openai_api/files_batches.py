"""OpenAI files and batches endpoints.

Counterpart of ``scratchpad_tpu/server/openai_api/files_batches.py`` on the
port's HTTP layer (``server/http_server.py``): upload a JSONL of chat or
completion requests as ``multipart/form-data``, run them through the engine
in the background, download the JSONL of results. The multipart body is
read with the standard library's ``email`` parser.
"""

from __future__ import annotations

import asyncio
import email.parser
import email.policy
import json
import time
import uuid
from typing import Any

from scratchpad_tpu_torch.server.http_server import Response, _sampling_from, json_response
from scratchpad_tpu_torch.server.openai_api.protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    parse,
)


def _multipart_parts(content_type: str, body: bytes) -> list[tuple[str, str, bytes]]:
    """(field name, file name or "", payload) of each part of a
    ``multipart/form-data`` body."""
    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n".encode()
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + body)
    if not msg.is_multipart():
        raise ValueError("expected a multipart/form-data body")
    parts = []
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition") or ""
        parts.append((name, part.get_filename() or "", part.get_payload(decode=True) or b""))
    return parts


class FilesAndBatches:
    def __init__(self, server_app):
        self.app = server_app
        self.files: dict[str, dict[str, Any]] = {}  # id -> {meta, content}
        self.batches: dict[str, dict[str, Any]] = {}
        self._tasks: set = set()

    def add_routes(self, router) -> None:
        router.add_post("/v1/files", self.upload_file)
        router.add_get("/v1/files/{file_id}", self.get_file)
        router.add_get("/v1/files/{file_id}/content", self.get_file_content)
        router.add_delete("/v1/files/{file_id}", self.delete_file)
        router.add_post("/v1/batches", self.create_batch)
        router.add_get("/v1/batches/{batch_id}", self.get_batch)
        router.add_post("/v1/batches/{batch_id}/cancel", self.cancel_batch)

    # ------------------------------------------------------------------ files

    def _store(self, content: bytes, filename: str, purpose: str) -> dict:
        fid = f"file-{uuid.uuid4().hex}"
        self.files[fid] = {
            "meta": {
                "id": fid,
                "object": "file",
                "bytes": len(content),
                "created_at": int(time.time()),
                "filename": filename,
                "purpose": purpose,
            },
            "content": content,
        }
        return self.files[fid]["meta"]

    async def upload_file(self, request, writer):
        purpose, content, filename = "batch", b"", "upload.jsonl"
        try:
            parts = _multipart_parts(request.headers.get("content-type", ""), request.body)
        except ValueError as e:
            return self.app._bad_request(str(e))
        for name, fname, payload in parts:
            if name == "purpose":
                purpose = payload.decode()
            elif name == "file":
                filename = fname or filename
                content = payload
        return json_response(self._store(content, filename, purpose))

    async def get_file(self, request, writer):
        f = self.files.get(request.match_info["file_id"])
        if f is None:
            return json_response({"error": "not found"}, 404)
        return json_response(f["meta"])

    async def get_file_content(self, request, writer):
        f = self.files.get(request.match_info["file_id"])
        if f is None:
            return json_response({"error": "not found"}, 404)
        return Response(f["content"], 200, "application/octet-stream")

    async def delete_file(self, request, writer):
        fid = request.match_info["file_id"]
        existed = self.files.pop(fid, None) is not None
        return json_response({"id": fid, "object": "file", "deleted": existed})

    # ---------------------------------------------------------------- batches

    async def create_batch(self, request, writer):
        body = request.json()
        input_file = body.get("input_file_id")
        endpoint = body.get("endpoint", "/v1/chat/completions")
        if input_file not in self.files:
            return json_response({"error": "input_file_id not found"}, 400)
        bid = f"batch_{uuid.uuid4().hex}"
        batch = {
            "id": bid,
            "object": "batch",
            "endpoint": endpoint,
            "input_file_id": input_file,
            "status": "in_progress",
            "created_at": int(time.time()),
            "output_file_id": None,
            "request_counts": {"total": 0, "completed": 0, "failed": 0},
        }
        self.batches[bid] = batch
        task = asyncio.create_task(self._run_batch(bid))
        self._tasks.add(task)  # the loop keeps only weak references
        task.add_done_callback(self._tasks.discard)
        return json_response(batch)

    async def _run_batch(self, bid: str) -> None:
        batch = self.batches[bid]
        lines = self.files[batch["input_file_id"]]["content"].decode().strip().splitlines()
        batch["request_counts"]["total"] = len(lines)
        results = []
        for line in lines:
            if batch["status"] == "cancelled":
                return
            item = None
            try:
                item = json.loads(line)
                resp = await self._run_one(batch["endpoint"], item.get("body", {}))
                results.append(
                    {
                        "id": f"batch_req_{uuid.uuid4().hex[:16]}",
                        "custom_id": item.get("custom_id"),
                        "response": {"status_code": 200, "body": resp},
                        "error": None,
                    }
                )
                batch["request_counts"]["completed"] += 1
            except Exception as e:  # noqa: BLE001 - one failed line fails only itself
                results.append(
                    {
                        "custom_id": item.get("custom_id") if isinstance(item, dict) else None,
                        "response": None,
                        "error": {"message": str(e)},
                    }
                )
                batch["request_counts"]["failed"] += 1
        out = "\n".join(json.dumps(r) for r in results).encode()
        batch["output_file_id"] = self._store(out, f"{bid}_output.jsonl", "batch_output")["id"]
        batch["status"] = "completed"
        batch["completed_at"] = int(time.time())

    async def _run_one(self, endpoint: str, body: dict) -> dict:
        if endpoint == "/v1/chat/completions":
            creq = parse(ChatCompletionRequest, body)
            self.app._flatten_content(creq.messages)
            prompt = self.app._apply_chat_template(creq.messages)
            sp = _sampling_from(creq, creq.max_completion_tokens or creq.max_tokens or 512)
            out = await self.app.runner.generate_full(prompt=prompt, sampling_params=sp)
            return {
                "id": f"chatcmpl-{uuid.uuid4().hex}",
                "object": "chat.completion",
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": out.text},
                        "finish_reason": out.finish_reason,
                    }
                ],
                "usage": {
                    "prompt_tokens": out.prompt_tokens,
                    "completion_tokens": out.completion_tokens,
                    "total_tokens": out.prompt_tokens + out.completion_tokens,
                },
            }
        creq = parse(CompletionRequest, body)
        sp = _sampling_from(creq, creq.max_tokens)
        prompts, idss = self.app._normalize_prompt(creq.prompt)
        out = await self.app.runner.generate_full(
            prompt=prompts[0], input_ids=idss[0], sampling_params=sp
        )
        return {
            "id": f"cmpl-{uuid.uuid4().hex}",
            "object": "text_completion",
            "choices": [{"index": 0, "text": out.text, "finish_reason": out.finish_reason}],
            "usage": {
                "prompt_tokens": out.prompt_tokens,
                "completion_tokens": out.completion_tokens,
                "total_tokens": out.prompt_tokens + out.completion_tokens,
            },
        }

    async def get_batch(self, request, writer):
        b = self.batches.get(request.match_info["batch_id"])
        if b is None:
            return json_response({"error": "not found"}, 404)
        return json_response(b)

    async def cancel_batch(self, request, writer):
        b = self.batches.get(request.match_info["batch_id"])
        if b is None:
            return json_response({"error": "not found"}, 404)
        if b["status"] == "in_progress":
            b["status"] = "cancelled"
        return json_response(b)
